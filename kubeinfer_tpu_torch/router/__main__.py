"""``python -m kubeinfer_tpu_torch.router`` — fleet router CLI."""

from kubeinfer_tpu_torch.router.server import main

if __name__ == "__main__":
    raise SystemExit(main())
