from .train_step import (TrainState, Zero1, broadcast_state, init_placed_state,
                         init_state, make_eval_step, make_train_step,
                         rank_rows, restore_state, save_state, sync_grads)

__all__ = ["TrainState", "make_train_step", "make_eval_step", "init_state",
           "save_state", "restore_state", "broadcast_state", "rank_rows",
           "sync_grads", "Zero1", "init_placed_state"]
