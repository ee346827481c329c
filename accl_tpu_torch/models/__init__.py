"""The model layer of the port: the flagship transformer's mesh forms
(forward, KV decode and train step over a dp x sp x tp (x pp) mesh of
virtual ranks) and its facade forms (the axis-free forward, the fused
train step and the fused KV-cache decode step over the ACCL facade), its
continuous-batching DecodeServer, and the MoE layer's mesh and facade
forms.

Counterpart of accl_tpu/models/.
"""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward_local,
    init_kv_cache,
    init_params,
    make_decode_step,
    make_decode_step_program,
    make_forward,
    make_train_step,
    make_train_step_program,
    record_decode_step,
    record_train_step,
    run_decode_step_eager,
    run_train_step_eager,
)
from .moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    make_moe_forward,
    make_moe_train_step,
)
from .serve import (  # noqa: F401
    DecodeRequest,
    DecodeServer,
    generate,
)
