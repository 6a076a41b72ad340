"""The search harness CLI (port of bang_tpu/harness): `python -m
bang_tpu_torch.harness.driver`."""
