"""Typed configuration — a field-for-field mirror of ``bundlefusion_tpu.config``.

The reference drives everything from two text parameter files parsed into global
singletons (``FriedLiver/zParametersDefault.txt`` -> ``GlobalAppState`` and
``FriedLiver/zParametersBundlingDefault.txt`` -> ``GlobalBundlingState``; see
SURVEY.md §2.1 "Config system"). We keep the same two-profile split and the
``s_``-less parameter names/semantics so reference configs translate
mechanically, but as frozen dataclasses serializable to/from JSON.

Every capacity here is a fixed tensor dimension in the pipeline, as in the
JAX package. Fields, defaults and the JSON round trip are identical, so one
config file drives both implementations. Settings the port does not
implement yet are rejected by ``BundleFusion.__init__``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AppConfig:
    """Mirror of GlobalAppState / zParametersDefault.txt (reconstruction side)."""

    # --- input ---
    sensor_idx: int = 8  # 8 = recorded data replay (SensorDataReader in the reference)
    input_width: int = 640
    input_height: int = 480
    integration_width: int = 640
    integration_height: int = 480
    depth_min: float = 0.1  # meters (s_sensorDepthMin)
    depth_max: float = 4.0  # meters (s_sensorDepthMax)
    depth_sigma_d: float = 2.0  # bilateral filter spatial sigma (s_depthSigmaD)
    depth_sigma_r: float = 0.1  # bilateral filter range sigma (s_depthSigmaR)
    depth_filter: bool = True  # s_depthFilter

    # --- TSDF volume (dense-block grid replaces voxel hashing; SURVEY §2.1) ---
    voxel_size: float = 0.004  # meters (s_SDFVoxelSize, 4 mm demo default)
    truncation: float = 0.02  # base truncation distance (s_SDFTruncation)
    truncation_scale: float = 0.01  # truncation growth per meter depth (s_SDFTruncationScale)
    max_integration_weight: float = 255.0  # s_SDFMaxIntegrationDistance-adjacent weight cap
    max_integration_distance: float = 4.0  # s_SDFMaxIntegrationDistance
    block_size: int = 8  # 8^3 voxel blocks, as in VoxelHashing
    block_capacity: int = 16384  # max live blocks (s_hashNumBuckets-equivalent capacity)
    blocks_per_frame_cap: int = 4096  # max new block allocations in one integrate step
    alloc_stride: int = 2  # pixel subsampling for block allocation rays
    # scale the allocation-ray stride with the block footprint: sampling every
    # `alloc_stride` pixels at 640x480 is ~5x denser than one ray per block
    # even at max_integration_distance. When on, the effective stride grows to
    # half the minimum block footprint in pixels (block_m * fx / max_dist / 2,
    # capped at 8) — physics-scaled, so low resolutions / big blocks are
    # unaffected while high-res allocation sheds most of its key-sort cost.
    alloc_stride_auto: bool = True
    # kept for config compatibility: the port always runs its CUDA integrate
    # kernel on CUDA tensors and the plain twin on CPU tensors
    use_pallas_tsdf: bool = True
    integration_weight_sample: float = 1.0  # per-frame integration weight (s_SDFIntegrationWeightSample)

    # --- streaming (out-of-core; config-5 scale) ---
    streaming_enabled: bool = True
    streaming_radius: float = 4.0  # active-volume radius around camera (s_streamingRadius)
    streaming_chunk_blocks: int = 16  # coarse chunk-grid cell edge, in blocks
    # stream-out engages only past this device-pool occupancy fraction, so
    # small scenes never pay host traffic; stream-in runs whenever the host
    # store holds blocks near the camera
    streaming_watermark: float = 0.5
    # the occupancy check reads device state (a host round-trip), so it runs
    # every N chunks until streaming first engages, then every chunk; 0
    # disables the periodic check entirely (streaming is not ported yet: the
    # port's pipeline raises at the first chunk where the check would fire)
    streaming_check_every: int = 16

    # --- raycast / preview ---
    raycast_width: int = 320
    raycast_height: int = 240
    raycast_max_steps: int = 192
    raycast_step_scale: float = 0.8  # step as fraction of truncation

    # --- marching cubes ---
    mc_max_triangles: int = 1 << 20  # capacity of the extracted triangle soup

    # --- re-integration (TrajectoryManager budget) ---
    # re-integration budget: up to this many frames de+re-integrate per NEW
    # frame integrated (the reference's TrajectoryManager emits a small
    # bounded top-k per frame). 1 = one correction per new frame — the fuse
    # scan runs chunk_size + 2*budget rows, so this directly sizes the
    # pipeline's biggest device program; deferred corrections are counted
    # (runlog n_reint / ring_miss) and drained by finalize().
    max_reintegrations_per_frame: int = 1
    # pose-delta thresholds past which an integrated frame is scheduled for
    # de+re-integration (the reference's TrajectoryManager pose-distance
    # parameters; lived as hardcoded trajectory.py defaults until round 3)
    reint_rot_thresh: float = 0.008  # radians
    reint_trans_thresh: float = 0.004  # meters
    # device-side cache of frames in wire format (uint16 mm / uint8) feeding
    # de/re-integration; the host FrameStore holds ALL frames (the reference
    # keeps every integrate-frame resident for exactly this reason), so the
    # ring size bounds upload traffic, not which frames can be re-integrated
    history_ring_frames: int = 1024
    # integrate the bilateral-filtered depth (re-quantized to wire format so
    # de-integration stays bit-exact) instead of the raw sensor depth; costs
    # one device->host depth download per chunk (s_depthFilter analog for the
    # reconstruction side)
    integrate_filtered_depth: bool = False
    # run TSDF garbage collection every N chunks (0 = never); reference GCs
    # per frame (CUDASceneRepHashSDF garbage-collect pass)
    gc_every_chunks: int = 8

    def validate(self) -> None:
        assert self.block_size == 8, "dense-block kernels are specialized to 8^3 blocks"
        assert self.depth_min < self.depth_max
        assert self.block_capacity % 128 == 0, "block table should be lane-aligned"


@dataclass(frozen=True)
class BundlingConfig:
    """Mirror of GlobalBundlingState / zParametersBundlingDefault.txt (tracking side)."""

    # --- hierarchy ---
    submap_size: int = 10  # frames per chunk minus overlap (s_submapSize)
    max_num_images: int = 512  # global keyframe capacity (s_maxNumImages)
    max_frames: int = 8192  # total frames capacity for trajectories

    # --- SIFT ---
    max_keys_per_image: int = 512  # s_maxNumKeysPerImage (reference ~1024 cap [M])
    sift_octaves: int = 3
    sift_scales_per_octave: int = 3  # intervals; 3 DoG extrema scales per octave
    sift_sigma: float = 1.6
    sift_contrast_thresh: float = 0.006  # DoG response threshold
    sift_edge_thresh: float = 10.0  # Hessian edge ratio threshold
    sift_depth_min: float = 0.1  # keys need valid depth for 3D lifting
    sift_depth_max: float = 4.0

    # --- matching ---
    max_matches_per_pair_raw: int = 128  # s_maxNumMatchesPerImagePair-equivalent
    max_matches_per_pair_filtered: int = 64
    match_ratio_thresh: float = 0.8  # Lowe ratio test (s_siftMatchRatioMaxLocal/Global)
    match_dist_thresh: float = 0.7  # max descriptor distance
    min_matches_local: int = 12  # s_minNumMatchesLocal
    min_matches_global: int = 16  # s_minNumMatchesGlobal

    # --- key-point (Kabsch) filter ---
    kabsch_max_res_thresh: float = 0.08  # 3D residual threshold (s_matchResidualThresh-ish)
    kabsch_min_inliers: int = 8

    # --- surface-area filter ---
    surf_area_pca_thresh: float = 0.032  # min spread of matched keys (s_surfAreaPcaThresh)

    # --- dense verify filter ---
    verify_width: int = 80
    verify_height: int = 60
    verify_dist_thresh: float = 0.1  # s_projCorrDistThres-equivalent
    verify_normal_thresh: float = 0.97  # cos of max normal deviation
    verify_color_thresh: float = 0.1  # intensity agreement
    verify_ok_fraction: float = 0.35  # min fraction of verified pixels
    verify_min_overlap: float = 0.08  # min fraction of reprojected valid pixels

    # --- solver (local = intra-chunk, global = inter-chunk) ---
    local_gn_iters: int = 3  # s_numLocalNonLinIterations
    local_pcg_iters: int = 32  # s_numLocalLinIterations
    global_gn_iters: int = 3  # s_numGlobalNonLinIterations
    global_pcg_iters: int = 64  # s_numGlobalLinIterations
    max_residuals_local: int = 1024  # sparse correspondence capacity, local solve
    max_residuals_global: int = 16384  # sparse correspondence capacity, global solve
    weight_sparse: float = 1.0  # s_weightSparse
    weight_dense_depth: float = 0.5  # s_weightDenseDepth (per-iter ramp in reference [M])
    weight_dense_color: float = 0.1  # s_weightDenseColor
    dense_dist_thresh: float = 0.15  # s_denseDistThresh
    dense_normal_thresh: float = 0.97  # s_denseNormalThresh
    dense_color_thresh: float = 0.1  # s_denseColorThresh
    dense_color_grad_min: float = 0.005  # s_denseColorGradientMin
    dense_overlap_check: bool = True  # gate global dense pairs on the dense-verify filter
    use_dense_local: bool = True  # dense terms in intra-chunk BA
    use_dense_global: bool = False  # reference: dense global optional (s_useGlobalDenseOpt)
    dense_pairs_per_kf: int = 8  # global dense pairs appended per new keyframe
    max_dense_pairs_global: int = 4096  # capacity of the global dense-pair list
    # ramp the dense weights across GN iterations (reference ramps
    # weightDenseDepth/Color per nonlinear iteration [M]): iteration i of n
    # uses weight * (i+1)/n, so sparse terms dominate early, dense refine late
    dense_weight_ramp: bool = True

    # --- residual pruning (post-solve) ---
    max_res_thresh: float = 0.16  # s_maxKabschResidual2-equivalent removal threshold
    prune_iters: int = 4  # max correspondences sets removed per solve round

    # --- verification of local solves ---
    verify_opt_err_thresh: float = 0.075  # s_verifyOptErrThresh
    verify_opt_corr_thresh: float = 0.05  # s_verifyOptCorrThresh

    # --- relocalization ---
    max_invalid_chunks_lost: int = 3  # consecutive invalid chunks => tracking lost
    # revalidation of stale invalidated chunks is host-driven (it reads the
    # device relocalization counter); by default it runs only at finalize() to
    # keep the steady state readback-free — set N > 0 to also check (and
    # recover geometry) every N chunks mid-run
    revalidate_every_chunks: int = 0

    # --- dense-BA cache (CUDACache equivalent) ---
    cache_width: int = 80
    cache_height: int = 60

    def validate(self) -> None:
        assert self.submap_size >= 2
        assert self.max_keys_per_image % 128 == 0, "key capacity should be lane-aligned"
        assert self.cache_width == self.verify_width and self.cache_height == self.verify_height

    @property
    def chunk_size(self) -> int:
        """Frames per chunk including the 1-frame overlap with the previous chunk."""
        return self.submap_size + 1


@dataclass(frozen=True)
class Config:
    app: AppConfig = field(default_factory=AppConfig)
    bundling: BundlingConfig = field(default_factory=BundlingConfig)

    def validate(self) -> None:
        self.app.validate()
        self.bundling.validate()

    # --- (de)serialization: two profiles, like the reference's two files ---
    def to_json(self) -> str:
        return json.dumps(
            {"app": dataclasses.asdict(self.app), "bundling": dataclasses.asdict(self.bundling)},
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "Config":
        raw: dict[str, Any] = json.loads(text)
        return Config(
            app=AppConfig(**raw.get("app", {})),
            bundling=BundlingConfig(**raw.get("bundling", {})),
        )

    @staticmethod
    def load(app_path: str | None = None, bundling_path: str | None = None) -> "Config":
        """Load from separate app/bundling JSON files (mirrors the reference's
        two-argv-files startup in ``FriedLiver.cpp :: main``)."""
        app = AppConfig()
        bundling = BundlingConfig()
        if app_path:
            with open(app_path) as f:
                app = AppConfig(**json.load(f))
        if bundling_path:
            with open(bundling_path) as f:
                bundling = BundlingConfig(**json.load(f))
        cfg = Config(app=app, bundling=bundling)
        cfg.validate()
        return cfg


def tiny_test_config() -> Config:
    """Small capacities for fast tests/CI (CPU-simulated devices)."""
    return Config(
        app=AppConfig(
            input_width=64,
            input_height=48,
            integration_width=64,
            integration_height=48,
            voxel_size=0.02,
            truncation=0.06,
            block_capacity=2048,
            blocks_per_frame_cap=512,
            raycast_width=64,
            raycast_height=48,
            raycast_max_steps=96,
            mc_max_triangles=1 << 19,
        ),
        bundling=BundlingConfig(
            submap_size=4,
            max_num_images=32,
            max_frames=256,
            max_keys_per_image=128,
            sift_octaves=2,
            max_matches_per_pair_raw=64,
            max_matches_per_pair_filtered=32,
            min_matches_local=6,
            min_matches_global=6,
            kabsch_min_inliers=5,
            local_pcg_iters=16,
            global_pcg_iters=24,
            # synthetic test scenes are wall/floor-heavy: planar geometry is
            # shift-invariant in depth/normals, so photometric agreement must
            # carry the verify decision -> tighter fraction + color threshold
            verify_ok_fraction=0.55,
            verify_color_thresh=0.08,
            max_residuals_local=256,
            max_residuals_global=1024,
            cache_width=32,
            cache_height=24,
            verify_width=32,
            verify_height=24,
        ),
    )
