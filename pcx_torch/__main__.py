"""``python -m pcx_torch``: the port's command-line launcher
(``pcx_torch.cli``)."""

from pcx_torch.cli import main

if __name__ == "__main__":
    import sys
    sys.exit(main())
