"""The host heap's policy (`utils/heap.keep_freed`, set by `driver._main`):
a large block a job frees is reused by the next allocation instead of
being unmapped and faulted in again."""

import resource

from torch_cpu import one_torch_thread  # noqa: F401
from vartrix_tpu_torch.utils import heap

MIB = 2 ** 20


def _faults(nbytes: int) -> int:
    """Minor page faults of allocating, zeroing and freeing nbytes (a
    bytearray: plain malloc, with no huge-page advice as NumPy gives its
    large arrays)."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    block = bytearray(nbytes)
    del block
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt - before


def test_keep_freed_is_set_and_idempotent():
    assert heap.keep_freed()
    assert heap.keep_freed()


def test_freed_large_block_is_reused():
    heap.keep_freed()
    pages = 96 * MIB // resource.getpagesize()
    _faults(96 * MIB)  # the heap grows to hold the block once
    # the second block lands on the first one's pages: a few faults at
    # most, against one a page when the block is unmapped on free
    assert _faults(96 * MIB) < pages // 20
