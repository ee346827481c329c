"""The model layer of the port: the serving half of the reference's
transformer (the axis-free forward, the fused KV-cache decode step over
the ACCL facade) and its continuous-batching DecodeServer.

Counterpart of accl_tpu/models/. The forms that need a multi-axis mesh
(make_forward, make_decode_step, init_kv_cache, make_train_step) and the
MoE family wait for the port's parallel layer.
"""

from .transformer import (  # noqa: F401
    TransformerConfig,
    forward_local,
    init_params,
    make_decode_step_program,
    record_decode_step,
    run_decode_step_eager,
)
from .serve import (  # noqa: F401
    DecodeRequest,
    DecodeServer,
    generate,
)
