from .trainer import Trainer, TrainConfig  # noqa: F401
