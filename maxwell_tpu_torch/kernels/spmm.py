"""BELLUnion SpMM entry points: the CUDA kernels' wrappers and their plain
PyTorch versions.

    bellunion_matmat(A, X, stream, precision)   Y = A @ X, one value stream
    bellunion_km_matmat(A, X, precision)        (K @ X, M @ X), X gathered once
    bellunion_matvec(A, x, stream, precision)   y = A @ x, m = 1
    bellunion_matmat_banded(AB, X, stream, precision)
                                                Y = A @ X, one launch of the
                                                first per row band

replace `bellunion_matmat_pallas`, `bellunion_km_matmat_pallas`,
`bellunion_matvec_pallas` and `bellunion_matmat_banded` of
maxwell_tpu/kernels/spmm.py. stream "a" is the
layout's first value stream (K), "b" its second (M). precision "highest" is
exact f32; "b3" forms vh*xh + vh*xl + vl*xh from the layout's bf16 (hi, lo)
value split (BELLUnion.bf16x3) and an in-kernel split of X, with f32
accumulation.

A wrapper given CUDA tensors checks them and launches its kernel
(csrc/bellunion_spmm.cu) or raises. The kernels read the layout's live form
(BELLUnion.live: the live 8 x 16 sub-blocks, compacted, and the X runs they
need); a layout without it raises. Given CPU tensors a wrapper runs the
plain version (`*_ref`, the full value streams), which the CPU tests hold
against the JAX package and the chip smoke holds the kernels against. Each
wrapper counts its kernel launches in `.launches` (a banded call counts
once), each plain version its calls in `.calls`. `_union_live_ref` computes
the product from the live form alone, as the kernels read it; no solver
calls it (the CPU tests hold it to the JAX package).

The banded form (a BandedBELLUnion, BELLUnion.banded) launches the
one-stream kernel once per band on that band's contiguous X window, a view
of X (padded only if a window runs past X's last row), writing into the
band's rows of one output: the same chunks and the same arithmetic as the
full-X kernel, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from maxwell_tpu_torch.sparse.bellunion import BandedBELLUnion, BELLUnion

_PRECISIONS = ("highest", "b3")


def _streams(A: BELLUnion, streams: str, precision: str):
    """[(hi, lo)] value tensors of each requested stream; lo is None in
    "highest" mode."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}")
    out = []
    for s in streams:
        if s not in "ab":
            raise ValueError(f"unknown value stream {s!r}")
        if precision == "b3":
            pair = (A.vals_h, A.vals_l) if s == "a" else (A.vals_b_h, A.vals_b_l)
            if pair[0] is None:
                raise ValueError(
                    "precision='b3' needs the bf16 split streams: build "
                    "with BELLUnion.bf16x3()"
                )
        else:
            pair = (A.vals if s == "a" else A.vals_b, None)
        if pair[0] is None:
            raise ValueError(f"value stream {s!r} not present")
        out.append(pair)
    return out


def _live_pairs(A: BELLUnion, streams: str, precision: str):
    """[(hi, lo)] compacted value tensors of the live form (A.live) for
    each requested stream, as _streams gives the full ones."""
    _streams(A, streams, precision)  # checks the names and the splits
    if A.live is None:
        raise ValueError(
            "the union kernels read the layout's live sub-blocks: this "
            "layout has no live form (BELLUnion.with_live)")
    out = []
    for s in streams:
        base = "vals" if s == "a" else "vals_b"
        names = (base + "_h", base + "_l") if precision == "b3" else (base,)
        pair = [getattr(A.live, f) for f in names]
        if any(v is None for v in pair):
            raise ValueError(
                f"the live form lacks stream {s!r} at precision {precision!r}")
        out.append((pair[0], pair[1] if len(pair) == 2 else None))
    return out


def _pad_rows(X: torch.Tensor, rows: int) -> torch.Tensor:
    if X.shape[0] >= rows:
        return X
    return torch.nn.functional.pad(X, (0, 0, 0, rows - X.shape[0]))


def _band_slices(AB: BandedBELLUnion, X: torch.Tensor):
    """(band, its X window, its first output row) of each band; the windows
    are views of X, zero-padded first only if a window runs past its end."""
    Xp = _pad_rows(X, max(cs + r for cs, r in zip(AB.col_starts,
                                                  AB.col_rows)))
    row = 0
    for bp, cs, rows in zip(AB.bands, AB.col_starts, AB.col_rows):
        yield bp, Xp[cs : cs + rows], row
        row += bp.n_padded


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _gather_rows(A: BELLUnion) -> torch.Tensor:
    """(NC, cl) row of X each value lane multiplies: lane c of chunk k reads
    X[ucols[k, g*pack]*b + q] with g = c // (pack*b), q = c % (pack*b)."""
    run = A.pack * A.b
    base = A.ucols[:, :: A.pack].long() * A.b  # (NC, cl // run)
    q = torch.arange(run, device=base.device)
    return (base[:, :, None] + q).reshape(A.n_chunks, A.cl)


def _union_ref(A: BELLUnion, X: torch.Tensor, streams: str, precision: str):
    """Gather X into (NC, cl, m), one bmm per chunk against (128, cl) value
    blocks, index_add_ the chunk results into their tiles."""
    pairs = _streams(A, streams, precision)
    m = X.shape[1]
    Xg = _pad_rows(X, A.n_cols_padded)[_gather_rows(A)]  # (NC, cl, m)
    if precision == "b3":
        xh = Xg.to(torch.bfloat16)
        xl = (Xg - xh.to(Xg.dtype)).to(torch.bfloat16)
        xh, xl = xh.float(), xl.float()
    tile_of = A.tile_of.long()
    out = []
    for hi, lo in pairs:
        vh = hi.view(A.n_chunks, 128, A.cl)
        if precision == "b3":
            vh = vh.float()
            vl = lo.view(A.n_chunks, 128, A.cl).float()
            d = torch.bmm(vh, xh) + torch.bmm(vh, xl) + torch.bmm(vl, xh)
        else:
            d = torch.bmm(vh, Xg)
        Y = torch.zeros((A.n_tiles, 128, m), dtype=d.dtype, device=d.device)
        out.append(Y.index_add_(0, tile_of, d).reshape(A.n_padded, m))
    return out


def _union_live_ref(A: BELLUnion, X: torch.Tensor, streams: str,
                    precision: str):
    """The product from the live form alone, as the kernels read it: per
    live sub-block, its 16 X rows (its run's lanes through ucols) times its
    (8, 16) values, added into its 8 rows of Y. Off every solver path."""
    L = A.live
    pairs = _live_pairs(A, streams, precision)
    dev = L.sb_ptr.device
    grp = torch.repeat_interleave(
        torch.arange(A.n_chunks * 16, device=dev),
        (L.sb_ptr[1:] - L.sb_ptr[:-1]).long())  # 16 chunk + row group
    chunk = grp // 16
    run = L.xr_run[L.xr_ptr[chunk].long() + L.sb_run.long()].long()
    lanes = run[:, None] * 16 + torch.arange(16, device=dev)
    rows = A.ucols[chunk[:, None], lanes // A.b].long() * A.b + lanes % A.b
    Xg = _pad_rows(X, A.n_cols_padded)[rows]  # (NSB, 16, m)
    if precision == "b3":
        xh = Xg.to(torch.bfloat16)
        xl = (Xg - xh.to(Xg.dtype)).to(torch.bfloat16)
        xh, xl = xh.float(), xl.float()
    dst = A.tile_of[chunk].long() * 16 + grp % 16  # output row group
    m = X.shape[1]
    out = []
    for hi, lo in pairs:
        if precision == "b3":
            vh, vl = hi.float(), lo.float()
            d = torch.bmm(vh, xh) + torch.bmm(vh, xl) + torch.bmm(vl, xh)
        else:
            d = torch.bmm(hi, Xg)
        Y = torch.zeros((A.n_tiles * 16, 8, m), dtype=d.dtype,
                        device=d.device)
        out.append(Y.index_add_(0, dst, d).reshape(A.n_padded, m))
    return out


def bellunion_matmat_ref(
    A: BELLUnion, X: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """Plain version of bellunion_matmat."""
    bellunion_matmat_ref.calls += 1
    return _union_ref(A, X, stream, precision)[0]


def bellunion_km_matmat_ref(
    A: BELLUnion, X: torch.Tensor, precision: str = "highest"
):
    """Plain version of bellunion_km_matmat."""
    bellunion_km_matmat_ref.calls += 1
    Yk, Ym = _union_ref(A, X, "ab", precision)
    return Yk, Ym


def bellunion_matvec_ref(
    A: BELLUnion, x: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """Plain version of bellunion_matvec."""
    bellunion_matvec_ref.calls += 1
    return _union_ref(A, x[:, None], stream, precision)[0][:, 0]


def bellunion_matmat_banded_ref(
    AB: BandedBELLUnion, X: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """Plain version of bellunion_matmat_banded: the plain product of each
    band on its X window, concatenated."""
    bellunion_matmat_banded_ref.calls += 1
    return torch.cat([_union_ref(bp, xw, stream, precision)[0]
                      for bp, xw, _ in _band_slices(AB, X)])


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_layout(A: BELLUnion, X: torch.Tensor, values, want,
                  tables=()) -> None:
    """What every union kernel needs: f32 X (rows, m >= 1), contiguous; the
    chunk width; the int32 tables ucols, tile_ptr, tile_end and `tables`;
    the value tensors `values` of dtype `want`, 16-byte aligned. All
    contiguous, on X's device."""
    if X.dtype != torch.float32:
        raise ValueError(f"the bellunion kernels take f32 X, got {X.dtype}")
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be (rows, m >= 1), got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if A.cl % 128 != 0 or A.cl % (A.b * A.pack) != 0:
        raise ValueError(f"chunk width {A.cl} must be a multiple of 128")
    tables = (A.ucols, A.tile_ptr, A.tile_end, *tables)
    for t in (*tables, *values):
        if t is None:
            continue
        if t.device != X.device:
            raise ValueError(f"layout on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError("layout tensors must be contiguous")
    for v in values:
        if v.dtype != want:
            raise ValueError(f"value stream is {v.dtype}, need {want}")
        if v.data_ptr() % 16:
            raise ValueError("value streams must be 16-byte aligned")
    if any(t is not None and t.dtype != torch.int32 for t in tables):
        raise ValueError("the layout's tables must be int32")


def _check_cuda(A: BELLUnion, X: torch.Tensor, pairs) -> None:
    """_check_layout for the live kernels: pairs are the compacted streams
    (_live_pairs), the tables the live form's."""
    values = [v for pair in pairs for v in pair if v is not None]
    want = torch.bfloat16 if pairs[0][1] is not None else torch.float32
    _check_layout(A, X, values, want,
                  tuple(getattr(A.live, f) for f in A.live._INDEX))
    if any(tuple(v.shape[1:]) != (8, 16) for v in values):
        raise ValueError("live value streams must be (NSB, 8, 16)")
    if (A.live.sb_ptr.numel() != 16 * A.n_chunks + 1
            or A.live.xr_ptr.numel() != A.n_chunks + 1):
        raise ValueError("the live form does not match the layout's chunks")


def _tables(A: BELLUnion) -> list:
    """Pointers to the tables every union entry point takes, in its order:
    sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end (None: the
    kernels stop each tile at tile_ptr[t + 1])."""
    L = A.live
    return [L.sb_ptr.data_ptr(), L.sb_run.data_ptr(), L.xr_ptr.data_ptr(),
            L.xr_run.data_ptr(), A.ucols.data_ptr(), A.tile_ptr.data_ptr(),
            None if A.tile_end is None else A.tile_end.data_ptr()]


def _launch(name: str, A: BELLUnion, X: torch.Tensor, pairs, outs) -> None:
    from maxwell_tpu_torch.kernels import _build

    values = [v.data_ptr() for pair in pairs for v in pair if v is not None]
    with torch.cuda.device(X.device):
        rc = getattr(_build.load(), name)(
            *values, *_tables(A), X.data_ptr(), *(Y.data_ptr() for Y in outs),
            A.n_tiles, X.shape[1], A.cl, A.b, A.live.x_max,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _matmat_cuda(A: BELLUnion, X: torch.Tensor, stream: str, precision: str,
                 Y: torch.Tensor | None = None):
    """One launch of the one-stream kernel into Y (n_padded, m), a new
    tensor unless given (contiguous, f32)."""
    pairs = _live_pairs(A, stream, precision)
    _check_cuda(A, X, pairs)
    Xp = _pad_rows(X, A.n_cols_padded)
    if Y is None:
        Y = torch.empty((A.n_padded, X.shape[1]), dtype=torch.float32,
                        device=X.device)
    name = "bellunion_matmat_b3" if precision == "b3" else "bellunion_matmat_f32"
    _launch(name, A, Xp, pairs, (Y,))
    return Y


def bellunion_matmat(
    A: BELLUnion, X: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """Y = A @ X, X (rows <= n_cols_padded, m), zero-padded to
    n_cols_padded rows; Y (n_padded, m) f32."""
    if X.device.type == "cpu":
        return bellunion_matmat_ref(A, X, stream, precision)
    Y = _matmat_cuda(A, X, stream, precision)
    bellunion_matmat.launches += 1
    return Y


def bellunion_km_matmat(
    A: BELLUnion, X: torch.Tensor, precision: str = "highest"
):
    """(K @ X, M @ X) in one kernel: each chunk's X block is gathered once
    and feeds both value streams."""
    if X.device.type == "cpu":
        return bellunion_km_matmat_ref(A, X, precision)
    pairs = _live_pairs(A, "ab", precision)
    _check_cuda(A, X, pairs)
    Xp = _pad_rows(X, A.n_cols_padded)
    Yk, Ym = (
        torch.empty((A.n_padded, X.shape[1]), dtype=torch.float32,
                    device=X.device)
        for _ in range(2)
    )
    name = (
        "bellunion_km_matmat_b3" if precision == "b3"
        else "bellunion_km_matmat_f32"
    )
    _launch(name, A, Xp, pairs, (Yk, Ym))
    bellunion_km_matmat.launches += 1
    return Yk, Ym


def bellunion_matvec(
    A: BELLUnion, x: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """y = A @ x for a vector x (length <= n_cols_padded); y (n_padded,).
    Unlike the reference (which widened x to 8 lanes and lost `precision`),
    this is a true m = 1 launch and honours `precision`."""
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bellunion_matvec_ref(A, x, stream, precision)
    y = _matmat_cuda(A, x[:, None], stream, precision)[:, 0]
    bellunion_matvec.launches += 1
    return y


def bellunion_matmat_banded(
    AB: BandedBELLUnion, X: torch.Tensor, stream: str = "a",
    precision: str = "highest",
) -> torch.Tensor:
    """Y = A @ X for a BandedBELLUnion, X (rows, m) with rows >= every
    band's window end or zero-padded to it; Y (AB.n_padded, m). "b3" needs
    bands built with split_bf16=True."""
    if X.device.type == "cpu":
        return bellunion_matmat_banded_ref(AB, X, stream, precision)
    Y = torch.empty((AB.n_padded, X.shape[1]), dtype=torch.float32,
                    device=X.device)
    for bp, xw, row in _band_slices(AB, X.contiguous()):
        _matmat_cuda(bp, xw, stream, precision, Y[row : row + bp.n_padded])
    bellunion_matmat_banded.launches += 1
    return Y


KERNELS = (bellunion_matmat, bellunion_km_matmat, bellunion_matvec,
           bellunion_matmat_banded)
PLAIN = (bellunion_matmat_ref, bellunion_km_matmat_ref, bellunion_matvec_ref,
         bellunion_matmat_banded_ref)


def reset_counts() -> None:
    """Zero every kernel's launch count and every plain version's call
    count."""
    for fn in KERNELS:
        fn.launches = 0
    for fn in PLAIN:
        fn.calls = 0


def counts() -> dict:
    """{name: launches} of the kernels and {name: calls} of the plain
    versions."""
    return {
        **{fn.__name__: fn.launches for fn in KERNELS},
        **{fn.__name__: fn.calls for fn in PLAIN},
    }


reset_counts()
