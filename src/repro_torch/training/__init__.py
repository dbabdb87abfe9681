from .train_step import (TrainState, init_state, make_eval_step,
                         make_train_step, restore_state, save_state)

__all__ = ["TrainState", "make_train_step", "make_eval_step", "init_state",
           "save_state", "restore_state"]
