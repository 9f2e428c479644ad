"""Training of the port: optimizers and schedules, the train step and the
loop (``repro.training``)."""
from repro_torch.training.optimizer import OptimizerConfig, \
    apply_updates, init_opt_state, schedule_fn
from repro_torch.training.train_step import TrainConfig, init_train_state, \
    make_train_step

__all__ = ["OptimizerConfig", "apply_updates", "init_opt_state",
           "schedule_fn", "TrainConfig", "init_train_state",
           "make_train_step"]
