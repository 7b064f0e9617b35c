"""The launch plan of K10a/K10b (ops/mxu.py, csrc/mxu_gj.cu), on any host.

K10 runs the panel tier's kernel (``csrc/gj_panel.cuh``) with its own
pivot step, ``mxu_gj.cu:ElementaryStep``: persistent blocks, the planes in
shared memory or in one workspace slot per resident block, [panel | C]
and G on chip. Its panel width is the TPU tier's, ``blocked_plan``'s P
(16 or 32), and the kernel has an instance of each. These tests hold the
plan's arithmetic, as ``ops/mxu.py:smem_bytes`` and
``workspace_systems`` copy it from the kernel, for N in [40, 128], real
and complex, f32 and f64: the place with the planes in the workspace
always fits one block's shared memory, so every N launches; the
workspace is the resident blocks' slots and does not grow with the batch;
the panel width equals the JAX package's. The card tests
(``tests/test_torch_cuda.py``) hold the copy to the kernel's own figures.
"""

import pytest
import torch

from spicey_tpu.ops import pallas_mxu as jmxu
from spicey_tpu_torch.ops import mxu
from spicey_tpu_torch.ops._build import SMEM_MAX

NS = range(mxu.MXU_MIN_N, mxu.MXU_MAX_N + 1)
# the most blocks an H100 can hold resident: 132 SMs x 2048 threads / 256
MAX_SLOTS = 132 * 8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("planes", [1, 2])
def test_plan_fits_shared_memory(planes, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    for n in NS:
        ws = mxu.smem_bytes(n, planes, item, mxu.PLANES_GLOBAL)
        on_chip = mxu.smem_bytes(n, planes, item, mxu.ALL_SMEM)
        assert ws <= SMEM_MAX, (n, ws)
        # the planes themselves, per plane n (n + 1) elements, are the
        # only difference between the two places
        assert on_chip - ws >= planes * n * (n + 1) * item
    # real f32 keeps every N on chip; complex f64 at N = 128 cannot
    assert mxu.smem_bytes(128, 1, 4, mxu.ALL_SMEM) <= SMEM_MAX
    assert mxu.smem_bytes(128, 2, 8, mxu.ALL_SMEM) > SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("planes", [1, 2])
def test_workspace_does_not_grow_with_the_batch(planes, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    for n in NS:
        slot = planes * n * (n + 1) * item
        sizes = {B: mxu.workspace_systems(mxu.PLANES_GLOBAL,
                                          min(B, MAX_SLOTS)) * slot
                 for B in (MAX_SLOTS, 52_224, 104_448, 10**7)}
        assert len(set(sizes.values())) == 1
        assert mxu.workspace_systems(mxu.ALL_SMEM, MAX_SLOTS) == 0
    # the sweep's complex f64 N = 128 batch: at most 1056 slots of 264 KB
    # (the one-block-per-system kernel held all 52,224 systems: 13.8 GB)
    assert mxu.workspace_systems(mxu.PLANES_GLOBAL, MAX_SLOTS) * 2 * 128 \
        * 129 * 8 < 3e8


def test_panel_width_is_the_tpu_tiers():
    for n in NS:
        p_ = mxu.blocked_plan(n)[0]
        assert p_ == jmxu.blocked_plan(n)[0]
        assert p_ in (16, 32) and p_ <= n  # an ElementaryStep instance
