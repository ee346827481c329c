"""The model layer of the port: the facade half of the reference's
transformer (the axis-free forward, the fused train step and the fused
KV-cache decode step over the ACCL facade), its continuous-batching
DecodeServer, and the MoE layer step's facade form.

Counterpart of accl_tpu/models/. The forms that need a multi-axis mesh
(make_forward, make_decode_step, init_kv_cache, make_train_step,
make_moe_forward, make_moe_train_step) wait for the port's parallel
layer.
"""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward_local,
    init_params,
    make_decode_step_program,
    make_train_step_program,
    record_decode_step,
    record_train_step,
    run_decode_step_eager,
    run_train_step_eager,
)
from .moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
)
from .serve import (  # noqa: F401
    DecodeRequest,
    DecodeServer,
    generate,
)
