"""Train a ~100M-parameter llama-family model on the PyTorch port for a few
hundred steps: synthetic resumable data, AdamW + cosine schedule, remat,
checkpointing every 100 steps (``repro_torch.launch.train``).

Run:  PYTHONPATH=src python examples/torch_train_small.py [--device cpu]
(on the CPU pass --d-model 128 as well for a fast demo; later flags win.)
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    args = [
        "--arch", "llama3-8b",
        "--d-model", "512",       # 512 wide x 8 layers + 256-wide head ~ 100M
        "--layers", "8",
        "--steps", "300",
        "--batch", "8",
        "--seq", "256",
        "--ckpt-dir", "results/torch_train_small",
        "--ckpt-every", "100",
    ] + sys.argv[1:]
    raise SystemExit(main(args))
