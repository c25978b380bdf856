from twoforone_torch.utils.config import TrainConfig, load_legacy_args_pickle  # noqa: F401
