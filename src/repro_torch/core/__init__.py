"""MDInference core: model registry, selection policies, duplication, SLA."""
