"""``python -m lkpy_tpu_torch`` entry point (the ``lkpy-tpu-torch`` CLI)."""

from lkpy_tpu_torch.cli import main

if __name__ == "__main__":
    main()
