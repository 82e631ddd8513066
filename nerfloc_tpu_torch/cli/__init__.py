"""Command-line entry points: `python -m nerfloc_tpu_torch.cli.train` and
`python -m nerfloc_tpu_torch.cli.test`."""
