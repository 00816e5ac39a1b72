"""Operator abstraction consumed by the solvers.

A `Pencil` bundles the stiffness K, the mass M and the gradient-nullspace
projector; the solvers call its methods, which dispatch to the configured
SpMM:

    kernel="union"  BELLUnion layout carrying both value streams (K as
                    stream a, M as stream b; M is None). CUDA tensors go
                    through the hand-written kernels (kernels/spmm.py), CPU
                    tensors through their plain versions.
    kernel="pallas" blocked-ELL with 8x8 blocks, K and M as two BSRMatrix
                    layouts. CUDA f32 tensors go through the hand-written
                    blocked-ELL kernels (kernels/bsr_spmm.py): the SpMV
                    for a vector or a one-column block, the SpMM
                    otherwise; CPU tensors through their plain versions.
    kernel="bellpairs"  paired-chunk blocked-ELL (sparse/bellpairs.py)
                    carrying both value streams on one pair structure (K as
                    stream a, M as stream b; M is None). CUDA f32 tensors go
                    through the hand-written kernels
                    (kernels/bellpairs_spmm.py): the fused K/M SpMM for
                    KM_mm, the one-stream SpMM for K_mm and M_mm (a vector
                    or a one-column block is a true m = 1 launch); CPU
                    tensors through their plain versions.
    kernel="ref"    blocked-ELL and a plain gather + einsum
                    (sparse/bsr.py): the f64 path.

The reference's VMEM routing for the union and bellpairs layouts (`max_m`,
`Kbanded`, the row-band split; maxwell_tpu/solvers/operator.py:133-174,
312-346) is TPU plumbing and is dropped: the CUDA kernels read X from global
memory at any size. The banded BELLPairs apply stays a ported entry point
(kernels/bellpairs_spmm.py) off the solve path.
"""

from __future__ import annotations

import dataclasses

import torch

from maxwell_tpu_torch.solvers.cg import cg
from maxwell_tpu_torch.solvers.deflation import GradientProjector
from maxwell_tpu_torch.sparse.bsr import BSRMatrix, bsr_matmat_ref

_KERNELS = ("ref", "union", "pallas", "bellpairs")
# layouts that carry M as K's second value stream (M is None)
_TWO_STREAM = ("union", "bellpairs")


def _check_kernel(kernel: str) -> None:
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")


@dataclasses.dataclass(frozen=True)
class Pencil:
    """The matrix pencil (K, M) plus nullspace projector.

    kernel: "union", "bellpairs", "pallas" or "ref" (the module docstring
    says what each runs). M may be None (standard eigenproblem, or
    kernel="union" / "bellpairs" where M is K's second value stream).
    proj may be None (no nullspace deflation).
    fastproj: exact tensor-product nodal solver for vacuum PEC bricks.
    precision: union dot precision, "highest" (exact f32) or "b3" (three
    bf16 products of the build-time value split; the f32 default).
    """

    K: object
    M: BSRMatrix | None = None
    proj: GradientProjector | None = None
    kernel: str = "ref"
    mass_tol: float = 1e-12
    mass_iters: int = 300
    fastproj: object | None = None
    precision: str = "highest"

    # --- shapes ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.K.n

    @property
    def n_padded(self) -> int:
        return self.K.n_padded

    @property
    def dtype(self) -> torch.dtype:
        return self._values.dtype

    @property
    def device(self) -> torch.device:
        return self._values.device

    @property
    def _values(self) -> torch.Tensor:
        if self.kernel == "union":
            return self.K.vals
        if self.kernel == "bellpairs":
            return self.K.vals2d
        return self.K.blocks

    # --- reductions -----------------------------------------------------
    def weigh(self, x: torch.Tensor) -> torch.Tensor:
        """Row ownership weights for inner products (identity here)."""
        return x

    def dot_mm(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """(m, k) <- A^T B over the row axis."""
        return A.T @ self.weigh(B)

    def dot_cols(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """(m,) <- column-wise inner products."""
        return torch.sum(A * self.weigh(B), dim=0)

    def dot_vv(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Inner product of two vectors (a 0-d tensor)."""
        return torch.dot(x, self.weigh(y))

    def dot_basis(self, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(k,) <- V @ w over the row axis, V (k, n) a basis held by rows."""
        return V @ self.weigh(w)

    def col_norms(self, A: torch.Tensor) -> torch.Tensor:
        """(m,) <- column norms."""
        return torch.sqrt(torch.clamp(self.dot_cols(A, A), min=0.0))

    # --- applies (padded in, padded out) --------------------------------
    def _union_mm(self, X: torch.Tensor, stream: str) -> torch.Tensor:
        from maxwell_tpu_torch.kernels.spmm import (
            bellunion_matmat,
            bellunion_matvec,
        )

        X = X.contiguous()
        if X.dim() == 1:
            return bellunion_matvec(
                self.K, X, stream=stream, precision=self.precision
            )
        return bellunion_matmat(
            self.K, X, stream=stream, precision=self.precision
        )

    def _pairs_mm(self, X: torch.Tensor, stream: str) -> torch.Tensor:
        from maxwell_tpu_torch.kernels.bellpairs_spmm import bellpairs_matmat

        vec = X.dim() == 1
        Y = bellpairs_matmat(
            self.K, (X[:, None] if vec else X).contiguous(), stream
        )
        return Y[:, 0] if vec else Y

    def _bsr_mm(self, A: BSRMatrix, X: torch.Tensor) -> torch.Tensor:
        vec = X.dim() == 1
        if self.kernel == "pallas":
            from maxwell_tpu_torch.kernels.bsr_spmm import (
                bsr_matmat,
                bsr_matvec,
            )

            X = X.contiguous()
            # a vector, or the (n, 1) block CG makes of one: the SpMV
            if vec or X.shape[1] == 1:
                y = bsr_matvec(A, X if vec else X[:, 0])
                return y if vec else y[:, None]
            return bsr_matmat(A, X)
        Y = bsr_matmat_ref(A, X[:, None] if vec else X)
        return Y[:, 0] if vec else Y

    def K_mm(self, X: torch.Tensor) -> torch.Tensor:
        if self.kernel == "union":
            return self._union_mm(X, "a")
        if self.kernel == "bellpairs":
            return self._pairs_mm(X, "a")
        return self._bsr_mm(self.K, X)

    def M_mm(self, X: torch.Tensor) -> torch.Tensor:
        if self.kernel == "union":
            return self._union_mm(X, "b")
        if self.kernel == "bellpairs":
            return self._pairs_mm(X, "b")
        if self.M is None:
            return X
        return self._bsr_mm(self.M, X)

    def KM_mm(self, X: torch.Tensor):
        """(K @ X, M @ X). kernel="union" and "bellpairs": ONE fused kernel
        — X gathered once per chunk (pair slot) and contracted against both
        value streams, for a vector too; kernel="pallas" and "ref": two
        single-operator applies, as in the reference."""
        if self.kernel == "bellpairs":
            from maxwell_tpu_torch.kernels.bellpairs_spmm import (
                bellpairs_km_matmat,
            )

            vec = X.dim() == 1
            Xl = (X[:, None] if vec else X).contiguous()
            Yk, Ym = bellpairs_km_matmat(self.K, Xl)
            return (Yk[:, 0], Ym[:, 0]) if vec else (Yk, Ym)
        if self.kernel == "union" and self.K.vals_b is not None:
            from maxwell_tpu_torch.kernels.spmm import bellunion_km_matmat

            vec = X.dim() == 1
            Xl = (X[:, None] if vec else X).contiguous()
            Yk, Ym = bellunion_km_matmat(self.K, Xl, precision=self.precision)
            return (Yk[:, 0], Ym[:, 0]) if vec else (Yk, Ym)
        return self.K_mm(X), self.M_mm(X)

    def Minv_mm(self, X: torch.Tensor) -> torch.Tensor:
        """M^-1 X via CG. A union or bellpairs pencil stores M as K's second
        stream (M is None there), so the identity shortcut applies to the
        blocked-ELL pencils only."""
        if self.kernel not in _TWO_STREAM and self.M is None:
            return X
        return cg(
            self.M_mm, X, tol=self.mass_tol, maxiter=self.mass_iters,
            dot=self.dot_cols,
        )

    def project(self, X: torch.Tensor) -> torch.Tensor:
        """M-orthogonal projection off the gradient nullspace (no-op
        without a projector)."""
        if self.proj is None:
            return X
        if self.fastproj is not None:
            vec = X.dim() == 1
            Xl = X[:, None] if vec else X
            rhs = self.proj.gt_mm(self.M_mm(Xl))
            out = Xl - self.proj.g_mm(self.fastproj.solve(rhs))
            return out[:, 0] if vec else out
        return self.proj.project(self.M_mm, X)

    # --- constructors ---------------------------------------------------
    @staticmethod
    def from_problem(
        problem,
        block: int | None = None,
        kernel: str = "ref",
        dtype: torch.dtype = torch.float32,
        precision: str = "auto",
        device: str | torch.device = "cuda",
    ) -> "Pencil":
        """Build from a cavity problem (RectCavity2D / BrickCavity3D /
        PermutedProblem). block default: 8 for the union, bellpairs and
        "pallas" layouts, 4 for the blocked-ELL reference. precision "auto":
        "b3" for a union pencil at f32, "highest" otherwise."""
        _check_kernel(kernel)
        if block is None:
            block = 8 if kernel in ("union", "pallas", "bellpairs") else 4
        M = None
        if kernel == "union":
            from maxwell_tpu_torch.sparse.bellunion import BELLUnion

            if precision == "auto":
                precision = "b3" if dtype == torch.float32 else "highest"
            K = BELLUnion.from_csr(
                problem.K, block=block, dtype=dtype, B=problem.M,
                device=device,
            )
            if precision == "b3":
                K = K.bf16x3()
        elif kernel == "bellpairs":
            from maxwell_tpu_torch.sparse.bellpairs import BELLPairs

            K = BELLPairs.from_csr(
                problem.K, block=block, dtype=dtype, B=problem.M,
                device=device,
            )
        else:
            # "pallas": slots aligned to 128 // b, as the reference builds it
            align = None if kernel == "pallas" else 4
            K, M = (
                BSRMatrix.from_csr(
                    A, block=block, align_slots=align, dtype=dtype,
                    device=device, kernel_metadata=kernel == "pallas",
                )
                for A in (problem.K, problem.M)
            )
        proj = GradientProjector.from_gradient(
            problem.G, K.n_padded, dtype=dtype, device=device
        )
        # exact tensor-product projector solve for vacuum PEC bricks: the
        # base problem's interior-node order is FastPoisson3D's layout, and
        # row permutations (PermutedProblem) leave the node space alone
        fastproj = None
        base = getattr(problem, "base", problem)
        if (
            getattr(base, "nz", None) is not None
            and getattr(base, "bc", "pec") == "pec"
            and getattr(base, "eps_r", None) is None
            and getattr(base, "mu_r", None) is None
        ):
            from maxwell_tpu_torch.solvers.fast_poisson import FastPoisson3D

            fastproj = FastPoisson3D.build(
                base.a, base.b, base.c, base.nx, base.ny, base.nz,
                dtype=dtype, device=device,
            )
        if precision == "auto":
            precision = "highest"
        return Pencil(
            K=K, M=M, proj=proj, kernel=kernel, fastproj=fastproj,
            precision=precision,
        )

    @staticmethod
    def from_reference(obj, device: str | torch.device = "cuda") -> "Pencil":
        """Carry a JAX `Pencil` (or any object with the same fields) over:
        its layout, GradientProjector (head/tail/weight) and FastPoisson3D
        (Vx, Vy, Vz, inv_lam); every leaf is read through np.asarray. A
        bellpairs pencil's banded split (`Kbanded`) is TPU routing and is
        not carried."""
        _check_kernel(obj.kernel)
        if obj.kernel == "union":
            from maxwell_tpu_torch.sparse.bellunion import BELLUnion

            K, M = BELLUnion.from_reference(obj.K, device), None
        elif obj.kernel == "bellpairs":
            from maxwell_tpu_torch.sparse.bellpairs import BELLPairs

            K, M = BELLPairs.from_reference(obj.K, device), None
        else:
            K = BSRMatrix.from_reference(obj.K, device)
            M = None if obj.M is None else BSRMatrix.from_reference(
                obj.M, device)
        proj = None
        if obj.proj is not None:
            proj = GradientProjector.from_reference(obj.proj, device)
        fastproj = None
        if obj.fastproj is not None:
            from maxwell_tpu_torch.solvers.fast_poisson import FastPoisson3D

            fastproj = FastPoisson3D.from_reference(obj.fastproj, device)
        return Pencil(
            K=K, M=M, proj=proj, kernel=obj.kernel,
            mass_tol=float(obj.mass_tol), mass_iters=int(obj.mass_iters),
            fastproj=fastproj, precision=obj.precision,
        )
