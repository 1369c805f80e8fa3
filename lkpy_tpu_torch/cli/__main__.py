"""``python -m lkpy_tpu_torch.cli`` entry point."""

from lkpy_tpu_torch.cli import main

if __name__ == "__main__":
    main()
