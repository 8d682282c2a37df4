from .trainer import (StragglerPolicy, Trainer, TrainerConfig, device_batch,
                      simple_train_step, trained_parameters)

__all__ = ["StragglerPolicy", "Trainer", "TrainerConfig", "device_batch",
           "simple_train_step", "trained_parameters"]
