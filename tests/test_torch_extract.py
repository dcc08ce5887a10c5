"""PyTorch port, the extraction (ops/kernels.extract_cuda and its four
plain versions) against the JAX package on the same numpy inputs:
  records - ops/kmers.kmer_positions vs the JAX kmer_positions;
  count   - ops/kmers.count_records vs the JAX kmer_positions with the
            JAX count_sorted's masking (SENTINEL keys, 0 edges where
            invalid);
  qv      - ops/validate._extract_ctx_qv vs the JAX _extract_ctx_qv;
  track   - ops/validate._extract_ctx vs the JAX _extract_ctx, whose
            keys the port sets to SENTINEL where the window is invalid
            (the JAX function leaves the garbage key there; both probes
            skip it).
Every position is compared, invalid ones included; all values are
integers, so every comparison is exact.  On CPU tensors the wrapper runs
the plain versions and counts no launch; the kernel itself is held
against them on the card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KS = [1, 3, 11, 21, 31, 32]
CASES = ["bad_runs", "bad_ends", "n_eq_k", "n_eq_k_plus_1", "all_bad",
         "last_window_valid"]
FORMS = ["records", "qv", "track", "count"]


def _codes(case: str, k: int) -> np.ndarray:
    """uint8 codes for one case, from a numpy seed; BAD is any code
    above 3 (4, and 5, 7, 9 and 255 as other non-ACGT bytes).  N is
    not a multiple of 16 in bad_runs (1000 + 3k) at any k of KS."""
    rng = np.random.default_rng(KS.index(k) * 100 + CASES.index(case))
    n = {"bad_runs": 1000 + 3 * k, "bad_ends": 203, "n_eq_k": k,
         "n_eq_k_plus_1": k + 1, "all_bad": 61 + k,
         "last_window_valid": 150 + k}[case]
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if case == "bad_runs":
        # runs of 1-40 BAD codes, and scattered single ones
        for start in rng.integers(0, n, 12):
            codes[start:start + rng.integers(1, 41)] = 4
        one = rng.random(n) < 0.01
        codes[one] = rng.choice(np.array([5, 7, 255], np.uint8), one.sum())
    elif case == "bad_ends":
        codes[0], codes[-1] = 4, 255
    elif case == "all_bad":
        codes[:] = 4
        codes[::7] = 9
    elif case == "last_window_valid":
        # the last window's bases are all valid, the base before it BAD:
        # it ends exactly at the buffer's end with no base after it
        codes[n - k - 1] = 4
    else:
        codes[rng.random(n) < 0.2] = 4
    return codes


def _jax(form: str, codes: np.ndarray, k: int):
    """The JAX function of `form` as numpy arrays, in the port's output
    order, keys as u64 (track keys masked to SENTINEL where invalid)."""
    import jax.numpy as jnp

    from kreeq_tpu.ops.kmers import kmer_positions
    from kreeq_tpu.ops.validate import _extract_ctx, _extract_ctx_qv

    c = jnp.asarray(codes)
    if form == "records":
        return tuple(np.asarray(x) for x in kmer_positions(c, k))
    if form == "count":
        keys, _isfw, edges, valid = (np.asarray(x) for x in
                                     kmer_positions(c, k))
        return (np.where(valid, keys, np.uint64(0xFFFFFFFFFFFFFFFF)),
                np.where(valid, edges, 0))
    if form == "qv":
        return tuple(np.asarray(x) for x in _extract_ctx_qv(c, k))
    keys, isfw, valid, ctx = (np.asarray(x) for x in _extract_ctx(c, k))
    return (np.where(valid, keys, np.uint64(0xFFFFFFFFFFFFFFFF)), isfw,
            valid, ctx)


def _same(got, want, what: str) -> None:
    from kreeq_tpu_torch.constants import keys_to_u64

    assert len(got) == len(want)
    assert np.array_equal(keys_to_u64(got[0].numpy()), want[0]), \
        f"{what}: keys"
    for i, (g, w) in enumerate(zip(got[1:], want[1:]), 1):
        assert g.shape == w.shape, f"{what}: output {i} shape"
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), f"{what}: output {i}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_plain_and_wrapper_match_jax(k, case):
    """Each form's plain version, and the wrapper on a CPU tensor, equal
    the JAX function at every position; the wrapper launches nothing."""
    from kreeq_tpu_torch.ops import kernels

    codes = _codes(case, k)
    before = dict(kernels.LAUNCHES)
    t = torch.from_numpy(codes)
    for form in FORMS:
        want = _jax(form, codes, k)
        _same(kernels.plain_extract(form)(t, k), want, f"plain {form}")
        _same(kernels.extract_cuda(t, k, form), want, f"wrapper {form}")
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("form", FORMS)
def test_wrapper_dtypes_and_shapes(form):
    """The wrapper's outputs: int64 keys, bool flags, uint8 edge bits or
    ctx, each of P = N - k + 1 positions."""
    from kreeq_tpu_torch.ops.kernels import extract_cuda

    codes = torch.from_numpy(_codes("bad_runs", 21))
    want = {"records": (torch.int64, torch.bool, torch.uint8, torch.bool),
            "qv": (torch.int64, torch.uint8),
            "track": (torch.int64, torch.bool, torch.bool, torch.uint8),
            "count": (torch.int64, torch.uint8)}
    out = extract_cuda(codes, 21, form)
    assert tuple(x.dtype for x in out) == want[form]
    assert all(x.shape == (codes.shape[0] - 20,) for x in out)


@pytest.mark.parametrize("n", [0, 5, 20])
@pytest.mark.parametrize("form", FORMS)
def test_no_window_gives_empty_outputs(form, n):
    """N < k (P <= 0, an empty buffer included): empty outputs of the
    form's dtypes, and no launch."""
    from kreeq_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    out = kernels.extract_cuda(torch.full((n,), 2, dtype=torch.uint8), 21,
                               form)
    full = kernels.extract_cuda(torch.full((21,), 2, dtype=torch.uint8), 21,
                                form)
    assert [(x.shape, x.dtype) for x in out] == \
        [((0,), x.dtype) for x in full]
    assert kernels.LAUNCHES == before


def test_wrapper_refuses_unknown_form_and_device():
    from kreeq_tpu_torch.ops.kernels import extract_cuda

    codes = torch.zeros(40, dtype=torch.uint8)
    with pytest.raises(ValueError, match="no form"):
        extract_cuda(codes, 21, "rows")
    with pytest.raises(ValueError, match="no kernel for device"):
        extract_cuda(codes.to("meta"), 21)


def test_main_path_extracts_through_the_wrapper(monkeypatch, tmp_path):
    """The build (through count_chunk_cuda), the QV sums and the track
    classification call the wrapper (which launches the kernel on the
    card), in their forms."""
    from kreeq_tpu_torch.core.table import KmerTable
    from kreeq_tpu_torch.ops import kernels
    from kreeq_tpu_torch.ops.validate import (validate_positions,
                                              validate_qv_sums)

    forms = []
    wrapped = kernels.extract_cuda

    def counting(codes, k, form="records"):
        forms.append(form)
        return wrapped(codes, k, form)

    monkeypatch.setattr(kernels, "extract_cuda", counting)
    rng = np.random.default_rng(5)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">r{i}\n{genome[s:s + 150]}\n" for i, s in
                             enumerate(rng.integers(0, 2850, 200))))
    table = KmerTable.from_reads([str(reads)], 21, "cpu", chunk=1 << 12)
    assert forms and set(forms) == {"count"}
    tab = (table.keys, table.cov, table.fw, table.bw)
    asm = torch.from_numpy(_codes("bad_runs", 21))
    validate_qv_sums(*tab, asm, 21, 0, 0, asm.shape[0] - 20)
    validate_positions(*tab, asm, 21, 0)
    assert forms[-2:] == ["qv", "track"]
