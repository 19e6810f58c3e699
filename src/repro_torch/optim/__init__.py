from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.grad_compress import (CompressConfig, compress_leaf,
                                             compress_with_feedback,
                                             wire_bytes)
from repro_torch.optim.schedule import lr_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_schedule", "CompressConfig", "compress_leaf",
           "compress_with_feedback", "wire_bytes"]
