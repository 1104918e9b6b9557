"""Float64 runs of the JAX package's models, for the port's parity tests.

The JAX modules cast to ``jnp.float32`` by name (gates, states, norms,
logits).  A test that wants them in float64 enables ``jax.enable_x64`` and
replaces the module's ``jnp`` by :class:`Jnp64` for the run (with
``monkeypatch``), so no file of the JAX package changes.
"""
import jax.numpy as jnp


class Jnp64:
    """``jax.numpy`` with ``float32`` standing for ``float64``: the JAX
    modules' explicit f32 casts then keep float64 under ``jax.enable_x64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)
