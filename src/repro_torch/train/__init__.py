"""Training: AdamW over trees of tensors and the train step.

The port of ``repro.train.optimizer`` and ``repro.train.train_step``
(``make_train_step``); the trainer is ``repro_torch.launch.train``, its
checkpoints and supervisor are in ``repro_torch.core.ft``."""
from repro_torch.train.optimizer import (AdamState, adamw_init, adamw_update,
                                         clip_by_global_norm, compress_grads,
                                         compressor_init, global_norm,
                                         lr_schedule)
from repro_torch.train.train_step import make_train_step

__all__ = ["AdamState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_grads", "compressor_init", "global_norm", "lr_schedule",
           "make_train_step"]
