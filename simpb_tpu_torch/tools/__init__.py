"""The port's command-line tools (`python -m simpb_tpu_torch.tools.<name>`)."""
