"""The NB-LDPC arithmetic code (the paper's contribution) in PyTorch.

The baseline ECCs it is compared against are in `core.baselines`."""
from .construction import LDPCCode, build_code
from .codes import get_code, REGISTRY as CODE_REGISTRY
from .encode import (encode_words, encode_weight_matrix, syndrome,
                     np_encode_words)
from .decode import DecodeResult, decode_llv, decode_integers, maxplus_conv
from .llv import init_llv, reinterpret, circular_distance
from .pim import PIMConfig, pim_mac
from .protected import (ProtectionConfig, ProtectedResult,
                        protected_pim_matmul, protected_pim_matmul_budgeted,
                        prepare_weights, strip_padding, decode_stream,
                        decode_pipelined)
from .context import PIMContext
