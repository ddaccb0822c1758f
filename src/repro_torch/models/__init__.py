"""Model substrate: layers, mixers and the composable LM stack (the
public names of ``repro.models``)."""
from repro_torch.models import lm
from repro_torch.models.layers import MoEConfig
from repro_torch.models.lm import (ModelConfig, decode_step, forward_train,
                                   init_params, init_serve_state, loss_fn,
                                   prefill)

__all__ = ["ModelConfig", "MoEConfig", "decode_step", "forward_train",
           "init_params", "init_serve_state", "lm", "loss_fn", "prefill"]
