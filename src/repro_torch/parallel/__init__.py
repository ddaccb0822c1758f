"""Distribution: sharding rules, gradient compression (port of
``repro.parallel``; the sequence-parallel state combine is
``repro_torch.core.linear_attention.sequence_parallel_state_combine``)."""
from repro_torch.parallel.compression import (compressed_psum_mean,
                                              init_error_feedback)
from repro_torch.parallel.sharding import (NamedSharding, P, batch_specs,
                                           constrain_batch_axis, dp_axes,
                                           full_tensors, local_batch,
                                           make_shardings, opt_state_specs,
                                           param_specs, place, place_tree,
                                           serve_state_specs)

__all__ = ["NamedSharding", "P", "batch_specs", "compressed_psum_mean",
           "constrain_batch_axis", "dp_axes", "full_tensors",
           "init_error_feedback", "local_batch", "make_shardings",
           "opt_state_specs", "param_specs", "place", "place_tree",
           "serve_state_specs"]
