from .dist import (all_reduce_grads_, all_reduce_metrics, broadcast_, broadcast_object,
                   init_distributed, replicate, shard_batch, world)
from .global_batch import (GlobalBatch, active, all_reduce_sum_, gather_rows,
                           gather_rows_grad, global_batch, global_count, global_mean,
                           global_rows, local_rows, share)
from .mesh import Grid, gather_params_tp, make_grid, shard_params_tp, tp_param_specs
from .tensor import (ColumnParallelDense, RowParallelDense, VocabParallelEmbed, copy_to_model,
                     reduce_from_model)
