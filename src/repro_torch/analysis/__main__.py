"""CLI entry point: ``python -m repro_torch.analysis PATH...``."""
import sys

from .engine import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
