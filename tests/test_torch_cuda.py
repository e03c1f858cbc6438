"""The port's hand-written kernels on a card: B5 (split paged attention)
against its plain version.  Every case carries the ``cuda`` marker and
skips without a card.  The file imports neither JAX nor the JAX package,
so it runs where they are not installed; on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` holds every kernel at the main paths' full widths.)
"""

import pytest
import torch

from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5

ULP = 2.0 ** -7         # one bf16 ulp, relative to a row's largest output


def _b5_case(storage: str, c: int, gen):
    """Rows of 0 to 96 slots over 32-slot pages, -1 past each row's last
    page; two rows shorter than C=4 and one empty."""
    r, hkv, hq, d, ps, maxp = 6, 2, 8, 128, 32, 3
    dtype = torch.bfloat16 if storage == "bf16" else torch.float8_e5m2
    n_pages = 1 + r * maxp
    k = torch.randn(n_pages, hkv, ps, d, generator=gen).to(dtype)
    v = torch.randn(n_pages, hkv, ps, d, generator=gen).to(dtype)
    kv_len = torch.tensor([1, 2, 37, 96, 0, 50], dtype=torch.int32)
    tables = (1 + torch.randperm(r * maxp, generator=gen)).to(
        torch.int32).reshape(r, maxp)
    for i in range(r):
        tables[i, -(-int(kv_len[i]) // ps):] = -1
    q = torch.randn(r, c, hq, d, generator=gen).to(torch.bfloat16)
    return q, k, v, tables, kv_len


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4])
def test_paged_attention_kernel_matches_plain(storage, c):
    """Two launches (the key-split pass and the merge), every query row
    within one bf16 ulp of its largest plain output, exact zeros where a
    query sees no key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _b5_case(storage, c, torch.Generator().manual_seed(c))
    fn = b5.paged_decode_sdpa if c == 1 else b5.paged_prefill_sdpa
    want = fn(*args).float()
    b5.COUNTS.reset()
    got = fn(*[t.cuda() for t in args]).float().cpu()
    assert b5.COUNTS.launches == 2 and b5.COUNTS.plain_calls == 0
    top = want.abs().amax(dim=(2, 3), keepdim=True)
    assert ((got - want).abs() <= ULP * top).all()
    assert not got[want.abs().amax(dim=(2, 3)) == 0].any()
