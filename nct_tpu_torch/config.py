"""Pipeline configuration of the port.

The same fields and defaults as ``nct_tpu/config.py`` (whose comments give
the reason for each default); the port keeps its own copy so that nothing
it imports belongs to the JAX package.  ``tests/test_torch_pipeline.py``
holds the two field lists, the defaults and the two methods below equal.
``space_mesh`` takes a ``parallel.mesh.Mesh`` (ranks of ``torch.distributed``)
where the JAX package takes a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import dataclasses

MAX_SIZE = 1000          # hard cap on the longer image side


@dataclasses.dataclass(frozen=True)
class Config:
    """All pipeline hyper-parameters (reference Config.h:55-98)."""

    # adjustable parameters
    reverse_weight: float = 2.0
    var_epsilon: float = 0.6
    nonlocal_weight: float = 2.0
    local_weight: float = 0.125
    wls_lambda_init: float = 0.024

    # usually-fixed parameters
    cluster_num: int = 10
    k_num: int = 8
    patch_size: int = 3
    wls_alpha: float = 1.2

    # algorithm schedule
    pm_iters: int = 10
    num_levels: int = 5
    max_size: int = MAX_SIZE

    # solver budgets
    cg_tol: float = 1e-4
    cg_iters_final: int = 25
    cg_iters: int = 50
    wls_cg_iters: int = 200
    wls_precond: str = "mg"
    wls_cg_iters_mg: int = 8
    nl_precond: str = "mg"
    cg_iters_mg: int = 10
    cg_iters_final_mg: int = 6
    cg_dynamic: bool = True

    # execution knobs
    feature_dtype: str = "bfloat16"
    vgg_compute_dtype: str = ""
    kmeans_iters: int = 11
    exact_nn_levels: int = 4
    pm_iters_fine: int = 4
    fine_strategy: str = "window"
    window_radius: int = 4
    window_shortlist: int = 2
    window_boxsum: str = "auto"
    window_stage1_channels: int = 0
    window_stage1_channels_maxsize: int = 32
    match_serialize: bool = False
    nl_in_cap: int = 128
    nl_transpose: str = "auto"
    knn_memberships: int = 1
    space_mesh: object = None    # parallel.mesh.Mesh (pipeline.row_sharded)
    space_axis: str = "space"

    @classmethod
    def reference_parity(cls, **overrides) -> "Config":
        """The reference-shaped configuration: PatchMatch at every level
        with 10 iterations, unhalved CG budgets, tolerance 1e-6 and the
        block-Jacobi nonlocal preconditioner."""
        base = dict(
            exact_nn_levels=0, fine_strategy="patchmatch",
            pm_iters=10, pm_iters_fine=10, nl_precond="block_jacobi",
            cg_iters=100, cg_iters_final=50, wls_cg_iters=400,
            wls_cg_iters_mg=100, cg_tol=1e-6,
        )
        base.update(overrides)
        return cls(**base)

    def pm_search_radii(self, max_len: int) -> list[int]:
        """Per-level PatchMatch random-search radii for an image pair whose
        longest side is ``max_len``."""
        return [max_len // 16, max_len // 32, max_len // 64, 32, 32]

    def vgg_layers(self) -> list[str]:
        """Coarse-to-fine post-ReLU feature taps; ``num_levels < 5`` keeps
        the coarsest levels (each level still refines at full resolution)."""
        taps = ["conv5_1", "conv4_1", "conv3_1", "conv2_1", "conv1_1"]
        return taps[: max(1, min(self.num_levels, len(taps)))]
