from .dist import (all_reduce_grads_, all_reduce_metrics, broadcast_, broadcast_object,
                   init_distributed, replicate, shard_batch, world)
from .global_batch import (GlobalBatch, active, all_reduce_sum_, gather_rows,
                           gather_rows_grad, global_batch, global_count, global_mean,
                           global_rows, local_rows, share)
