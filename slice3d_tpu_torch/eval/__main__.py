"""``python -m slice3d_tpu_torch.eval``: see ``eval/cli.py``."""

from .cli import main

if __name__ == "__main__":
    main()
