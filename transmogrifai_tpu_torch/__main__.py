"""``python -m transmogrifai_tpu_torch`` — the CLI (see ``cli.py``)."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
