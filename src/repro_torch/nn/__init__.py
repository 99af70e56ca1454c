from .gnn import (GNNConfig, centralized_aggregate_fn, centralized_forward,
                  gnn_forward, init_gnn, masked_loss_and_correct,
                  params_from_jax, params_to)
from .modules import (dense, dense_init, layer_norm, param_count,
                      rms_norm, softmax_cross_entropy)

__all__ = [
    "GNNConfig", "centralized_aggregate_fn", "centralized_forward",
    "gnn_forward", "init_gnn", "masked_loss_and_correct",
    "params_from_jax", "params_to",
    "dense", "dense_init", "layer_norm", "param_count", "rms_norm",
    "softmax_cross_entropy",
]
