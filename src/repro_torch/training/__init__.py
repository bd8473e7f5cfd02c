from .checkpoint import load_checkpoint, save_checkpoint
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        lr_schedule)
from .train_step import (init_train_state, make_lora_train_step,
                         make_train_step)
