from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    combine_partials,
    decode_attention,
    decode_attention_partials,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    combine_partials_reference,
    decode_attention_reference,
    decode_partials_reference,
)
