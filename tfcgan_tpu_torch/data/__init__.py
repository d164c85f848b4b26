"""Data loading of the port: synthetic batches and paired PNG datasets."""

from tfcgan_tpu_torch.data.synth import synthetic_batch, synthetic_iterator
