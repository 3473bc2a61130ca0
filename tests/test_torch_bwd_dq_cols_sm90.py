"""K5 above head_dim 256 on the warpgroup kernel, on the CPU.

bf16 K5 (the two-pass pair's dq half) at head_dim 384 and 512, and at every
head dim padded to them (257-512), runs ``csrc/flash_bwd_dq_cols_sm90.cu``
on the card; f32 above 256 and bf16 above 512 stay on
``csrc/flash_bwd_dq_dstream.cu``. What can be checked here, with no card:
the dispatch, the new source's build entry and launch counter, and that it
keeps the column-group dq kernel's C contract: the same argtypes, the C
entry's parameters in that order, and the prepare pass's scratches (q
rotated and scale-folded, k rotated under rope, the f32 dq sum). The
two-pass route itself at 384 and 512 is held against the JAX package's
``_flash_backward`` by ``tests/test_torch_bwd_cols_sm90.py``.
"""

import ctypes
import re

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops import attention as TA

pytestmark = pytest.mark.torch_port

NEW = "flash_bwd_dq_cols_sm90"


@pytest.mark.parametrize("dh,dtype,want", [
    (257, torch.bfloat16, NEW), (320, torch.bfloat16, NEW), (384, torch.bfloat16, NEW),
    (400, torch.bfloat16, NEW), (512, torch.bfloat16, NEW),
    (384, torch.float32, "flash_bwd_dq_dstream"), (512, torch.float32, "flash_bwd_dq_dstream"),
    (640, torch.bfloat16, "flash_bwd_dq_dstream"),
])
def test_k5_above_256_dispatch(dh, dtype, want):
    """bf16 K5 at the instances 384 and 512 runs the warpgroup kernel; f32
    and bf16 above 512 the column-group kernel."""
    assert TA.backward_dq_kernel(dtype, TA._instance_dim(dh)) == want


def test_k5_warpgroup_source_is_built_and_counted():
    assert NEW in _build.sources()
    assert NEW in TA.SOURCE_LAUNCHES
    assert _build.library_path(NEW).name.startswith(f"{NEW}-")
    text = (_build.CSRC / f"{NEW}.cu").read_text()
    # the warpgroup pieces, and the column-group family's prepare pass
    assert '#include "sm90_common.cuh"' in text and '#include "flash_dstream.cuh"' in text
    assert TA._SOURCE_ARGTYPES[NEW] is TA._SOURCE_ARGTYPES["flash_bwd_dq_dstream"]
    assert NEW in TA._PREP_SOURCES
    for rope in (True, False):
        assert TA._scratch_specs(NEW, torch.bfloat16, 2, 4, 2, 16, 24, 512, rope) == (
            ((2, 4, 16, 512), torch.bfloat16),
            ((2, 2, 24, 512), torch.bfloat16) if rope else None,
            ((2, 4, 16, 512), torch.float32))


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const long long*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("source", [NEW, "flash_bwd_dq_dstream"])
def test_k5_c_entry_matches_its_argtypes_and_plan(source):
    """The C entry's parameter types, in order, are the source's argtypes,
    and a K5 launch's plan fills them: the operand pointers, the plan's
    strides and arguments, its scratches and the stream."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int dtt_{source}\((.*?)\)', text, re.S).group(1)
    # each parameter is written "<type> <name>", the pointer star on the type
    types = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0] for p in params.split(",")]
    assert [_C_TYPES[t] for t in types] == TA._SOURCE_ARGTYPES[source]
    b, h, kv, s, d = 2, 4, 2, 16, 512
    q, g, dq = (torch.empty(b, h, s, d, dtype=torch.bfloat16) for _ in range(3))
    k, v = (torch.empty(b, kv, s, d, dtype=torch.bfloat16) for _ in range(2))
    cos = torch.empty(1, s, d // 2)
    plan = TA._view_plan(source, q, k, (q, k, v, g, dq), True, None, 0, 0.1, cos)
    pointers = 9  # q, k, v, dout, lse, delta, cos, sin, dq: _launch_backward_dq's
    assert pointers + len(plan.args) + len(plan.scratch) + 1 == len(types)
