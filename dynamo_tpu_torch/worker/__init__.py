"""Backend worker process: `python -m dynamo_tpu_torch.worker`."""
