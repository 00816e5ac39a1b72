"""Driver / CLI: `python -m maxwell_tpu_torch.cli.run <config.json>`."""
