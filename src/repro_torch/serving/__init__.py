"""Serving layer: the batched map *evaluation* hot path (``evaluate``:
launcher groups behind ``POST /v1/evaluate``) and the binary evaluation
wire codec (``wire``: zero-copy array framing plus the encoded-response
LRU), and the LM engine (``engine``: prefill + greedy decode).  The socket
frontends are not ported yet."""
from repro_torch.serving.evaluate import (  # noqa: F401
    EvalStats, EvaluationService, encoded_batch_response, hydrate_result,
    wire_result,
)
from repro_torch.serving.wire import (  # noqa: F401
    WireCache, WireFormatError, decode_frame, encode_frame,
)
