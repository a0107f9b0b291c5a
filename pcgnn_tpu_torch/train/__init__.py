from pcgnn_tpu_torch.train.legacy_log import LegacyLog  # noqa: F401
