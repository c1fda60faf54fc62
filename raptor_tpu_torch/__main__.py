"""``python -m raptor_tpu_torch``: the command line (``cli.py``)."""
from raptor_tpu_torch.cli import main

if __name__ == "__main__":
    main()
