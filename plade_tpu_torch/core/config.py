"""Configuration for the PLADE registration pipeline.

A copy of ``plade_tpu/core/config.py``: that package imports JAX when it is
imported, and this one must run where JAX is absent.  The fields, their
defaults and ``derived`` are the same; ``tests/test_torch_core.py`` pins
the copy to the original.  "TPU" below is the reference's wording.

The reference hard-codes all parameters as local constants derived from the
source cloud's average point spacing (reference: code/PLADE/plade.cpp:46-56)
and RANSAC defaults (code/PLADE/plane_extraction.h:56-63).  Here they are
promoted to a frozen dataclass so they are visible, overridable, and hashable
(usable as a jit static argument).

Two kinds of fields exist:

* **Semantics parameters** mirroring the reference (same defaults).
* **Shape parameters** (``max_*``): TPU programs are compiled for static
  shapes, so every data-dependent count in the reference (planes per cloud,
  lines, hypotheses, candidates) becomes a padded buffer with a mask.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PladeConfig:
    # ----- derived-parameter multipliers (reference: plade.cpp:46-56) -----
    #: voxel-grid leaf = ``downsample_factor * average_spacing``
    downsample_factor: float = 4.0
    #: length threshold = ``length_factor * average_spacing``
    length_factor: float = 5.0
    #: pose / plane-consistency angle threshold (radians); reference 5 deg
    angle_threshold: float = 5.0 / 180.0 * math.pi
    #: weight of the matched-plane fraction in the final score (plade.cpp:561)
    face_matches_weight: float = 0.2
    #: max verified candidates (plade.cpp:54)
    max_candidate_results: int = 200
    #: fixed radius in descriptor space (util.cpp:115)
    descriptor_match_radius: float = 0.04
    #: per-query neighbor cap in the descriptor radius match.  The
    #: reference's fixed-radius search is unbounded-k (util.cpp:115,
    #: maxNeighbor=0 from plade.cpp:55); the TPU match keeps the nearest
    #: ``match_per_query`` per query row and counts rows whose cap
    #: filled (``match_saturated``).  128 measures zero saturation on
    #: the flagship + eval scenes (r4's 64 dropped hits on 29 rows of
    #: the polyhedron pair); raise if match_saturated reports nonzero.
    match_per_query: int = 128
    #: line pairs must differ in direction by more than this (plade.cpp:513)
    line_pair_min_angle: float = 10.0 / 180.0 * math.pi
    #: plane pairs more parallel than this produce no line (util.cpp:634)
    plane_pair_max_cos: float = 0.95
    #: target/source swapped when source >= 1.2x target (plade.cpp:690)
    swap_size_ratio: float = 1.2
    #: intersection lines farther than ``line_radius_factor x`` the cloud
    #: OBB's enclosing-sphere radius (half-diagonal) from the bounding
    #: center are discarded, and candidate poses whose transformed source
    #: center exceeds the same bound are rejected.  DELIBERATE DEVIATION:
    #: the reference uses max(width,height,depth)/2 (plade.cpp:84,137-142,
    #: util.cpp:359-363) — a sphere that does NOT contain the cloud, so on
    #: partial scans it rejects true wall-intersection lines near the scan
    #: perimeter and can reject the true pose outright (measured: the
    #: small-overlap scenario loses all but one corresponding line).  The
    #: half-diagonal is the tightest center-sphere containing the box:
    #: any line farther away cannot touch observed points, so this keeps
    #: strictly more true lines while still pruning junk.
    line_radius_factor: float = 1.0

    # ----- plane extraction (reference: plane_extraction.h:56-63, extract()
    # auto-tuner plade.cpp:602-635) -----
    ransac_dist_thresh: float = 0.005   # x cloud scale (max bbox extent)
    ransac_bitmap_reso: float = 0.02    # x cloud scale
    ransac_normal_thresh: float = 0.8
    ransac_overlook_prob: float = 0.001
    ransac_init_min_support: int = 10000
    ransac_min_allowed_support: int = 200
    ransac_max_trials: int = 10
    #: auto-mode extraction starts directly at the floor support instead
    #: of walking the reference's 10000 -> 200 halving cascade.  SOUND
    #: because (a) the support threshold is re-selected a posteriori
    #: (select_planes_device implements the reference auto-tuner's
    #: schedule on the extracted set), and (b) big-to-small extraction
    #: order is preserved by the acceptance rule itself: lanes accept in
    #: exact-inlier-count order and a plane is only eligible once its
    #: overlook failure probability (1-k/4N)^drawn clears the bound — a
    #: floor-support plane needs ~|log overlook|*4N/k draws, by which
    #: point every larger plane has long been eligible.  Removes the
    #: 2-round exhaustion streak each halving level cost (measured r4:
    #: 32 rounds, of which ~9 were termination walking).  The pinned
    #: min-support overload (plade.cpp:583-599) is unaffected.
    ransac_flat_support: bool = True
    min_planes: int = 10
    max_planes: int = 40
    #: candidate planes drawn per greedy round (TPU batched RANSAC; the
    #: reference draws 200/round lazily — RansacShapeDetector.cpp:89-191.
    #: Subset scoring is one matmul, so a wide draw batch costs little and
    #: the overlook-probability draw budget is met in few rounds: 2048
    #: front-loads the floor-level budget into ~2 rounds, which with pool
    #: dedup + 4 accept lanes collapses the polyhedron extraction to 8
    #: greedy rounds measured vs 32 in round 4.)
    ransac_candidates_per_round: int = 2048
    #: locality-stratified sampling pyramid depth for 3-point draws (the
    #: reference samples octree cells at an adaptively weighted level,
    #: RansacShapeDetector.cpp:89-191; level l cell radius = extent/2^(l+1))
    ransac_levels: int = 8
    #: candidate-pool size persisted across greedy rounds (the reference's
    #: candidate tournament keeps all candidates; the pool is rescored
    #: exactly every round so stale scores cannot win)
    ransac_pool: int = 32
    #: candidates and pool entries are scored on every
    #: ``ransac_score_subset``-th point (estimate scaled back up) — the
    #: reference's subset scoring (Candidate::ImproveBounds on stratified
    #: octrees); acceptance acts only on the exact-lane full rescores
    ransac_score_subset: int = 8
    #: 3-point companion draws come from every ``ransac_draw_subset``-th
    #: point (the (N_draw x S/2) anchor-distance block is the widest
    #: per-round array; a draw subset only thins the companion-sampling
    #: population, which stays unbiased)
    ransac_draw_subset: int = 8
    #: pool entries exactly rescored on ALL points per round (one
    #: (N, A_chk) matmul); acceptance, debunking, and the multi-accept
    #: greedy act on these.  Checking is one extra matmul column per
    #: lane — nearly free — while refit/trim are per-lane heavy, so at
    #: most ``ransac_exact_lanes`` of the checked lanes proceed to
    #: acceptance per round.  A wide check set drains the pool of noisy
    #: subset estimates many lanes per round (measured: the extraction
    #: tail spent 11 rounds debunking a ~30-entry pool at 2 checks/round)
    ransac_check_lanes: int = 16
    #: checked lanes that proceed to refit + CC-trim + acceptance per
    #: round.  Per-lane refit/trim used to be the round's marginal cost;
    #: with the pool dedup (check lanes hold DISTINCT planes) and the
    #: lane-batched CC kernel (one launch for all lanes), wide accept
    #: waves are nearly free and rounds are what batched/lockstep
    #: extraction depth is made of: 6 lanes + 16 check lanes measured
    #: 5 rounds / 0.402 s single-pair vs 7 rounds / 0.452 at 4+8
    ransac_exact_lanes: int = 6
    #: two exact lanes conflict (only the larger is accepted this round)
    #: when they share more than this fraction of the smaller inlier set
    ransac_conflict_frac: float = 0.3
    #: CC-trim bitmap occupancy/component sizes accumulate from every
    #: ``ransac_trim_subset``-th point (the scatter-adds are the trim's
    #: hot ops); each point's membership stays exact via its cell label.
    #: 1 = exact: near-min-support planes often have ~1 point per bitmap
    #: cell, where subset occupancy shatters the component
    ransac_trim_subset: int = 1
    #: hard cap on greedy rounds (safety net; the overlook-probability
    #: termination normally fires long before)
    ransac_max_rounds: int = 512
    #: least-squares refit rounds per accepted plane (RansacShapeDetector.cpp:633)
    ransac_refit_rounds: int = 3
    #: bitmap connected-component resolution (cells per side; the cell is
    #: stretched when a plane spans more cells, mirroring the reference's
    #: extent-sized bitmap)
    bitmap_grid: int = 64
    #: CC label-propagation iterations of the HLO fallback path (CPU
    #: tests, dry-runs).  Each iteration is one 3x3 min stencil + four
    #: pointer jumps (each jump squares the propagation distance); 6
    #: saturates a 64^2 grid for blob-like components (measured:
    #: identical extraction output vs 8, ~10% less round latency).
    bitmap_cc_iters: int = 6
    #: CC iterations of the TPU Pallas kernel (kernels/cc.py — plain 3x3
    #: min propagation, no pointer jumps, all iterations inside one
    #: in-VMEM kernel so extra iterations are nearly free).  256 covers
    #: any path of that length on the 64^2 grid; raise toward grid^2/2
    #: for pathologically serpentine supports.
    bitmap_cc_iters_tpu: int = 256

    # ----- line confidence (plade.cpp:144-162, util.h:389-426) -----
    #: cull lines whose confidence (min over the two supporting planes of
    #: ``|plane ds points| * dsd^2 / mean-squared line-to-plane-cloud
    #: distance``) falls below this.  The reference computes the value with
    #: threshold 1.0 but the cull is commented out (plade.cpp:161) —
    #: default 0.0 preserves that live behavior; set ~1.0 to enable the
    #: paper's gate on noisy scans.
    min_line_confidence: float = 0.0
    #: sampling interval along the line (world units; reference 0.5,
    #: plade.cpp:150) — stretched when the span exceeds
    #: ``line_conf_samples`` steps
    line_conf_interval: float = 0.5
    line_conf_samples: int = 32

    # ----- degraded 6-D descriptor families (feature flag) -----
    #: also match the 22-21 / 22-12 degraded 6-D families: target 2-2
    #: pairs emit the reference's 4 pseudo-plane variants each
    #: (util.cpp:830-919) and source 2-2 pairs emit 2-variant degraded
    #: QUERIES against them.  In the reference these families are built
    #: but only ever queried from dead boundary-line code
    #: (plade.cpp:176,384), so the flag is OFF by default (reference-live
    #: semantics); enable on plane-poor scenes where a line's support
    #: plane may be unextracted in one cloud.
    enable_degraded_families: bool = False
    max_degraded_matches: int = 8192

    # ----- average spacing (util.cpp:1619-1648) -----
    #: neighbours of each sample, itself included.  On a card the top-k is
    #: K4, which keeps 1 to ``kernels.nn.TOPK_MAX_K`` (16) and raises a
    #: ValueError at the spacing stage for any other k; the CPU takes any
    spacing_k: int = 6
    spacing_samples: int = 10000

    # ----- verification (util.cpp:352-511, 1279-1458) -----
    penetration_min_points: int = 10
    penetration_ratio: float = 5.0
    penetration_samples: int = 32
    enable_penetration_filter: bool = True
    #: exact-overlap verification budget (phase 2 of the two-phase scorer;
    #: phase 1 ranks all candidates by a superset-approximate score)
    overlap_exact_k: int = 8
    #: dense occupancy bitmap resolution (cells per side)
    overlap_grid: int = 256
    #: ORIENTED overlap: an exact-phase hit requires a radius-neighbor
    #: whose normal agrees (transformed source normal . target normal >=
    #: this cosine).  DELIBERATE DEVIATION from the reference's
    #: position-only ComputeOverlap (util.h:611-647): under repetitive
    #: structure an aliasing pose (e.g. a 180-degree room flip onto a
    #: geometry replica) can beat the true pose on raw point overlap —
    #: measured on the synthetic RESSO scenes, where the aliased winner
    #: scored 0.84 vs the true pose's 0.74 while matching fewer planes.
    #: Orientation gating deflates exactly those replica hits (normals of
    #: non-repeating structure disagree) and costs the true pose nothing.
    #: Default cos(45 deg) tolerates per-point normal noise well past any
    #: realistic scanner estimate; 0.0 restores reference-exact scoring.
    overlap_normal_cos: float = 0.7071067811865476

    # ----- padded shapes (TPU static-shape budget) -----
    max_points: int = 131072          #: padded full-resolution cloud size
    max_ds_points: int = 16384        #: padded downsampled cloud size
    max_plane_points: int = 2048      #: padded per-plane downsampled points
    max_lines: int = 256              #: padded intersection-line count
    max_query_pairs: int = 8192       #: padded source line-pair count
    max_target_pairs: int = 16384     #: padded target descriptor count
    max_matches: int = 32768          #: padded (query, target) match count
    #: hypothesis rows entering pose clustering.  Matches are
    #: front-compacted, so clustering a static prefix covers every live
    #: hypothesis whenever the total fits (flagship pair: 7.3k total);
    #: rows beyond the budget are dropped from clustering LOUDLY
    #: (``cluster_truncated`` in results/info).  A static prefix replaces
    #: round 4's dynamic lax.cond tier dispatch, which under vmap
    #: (batched/sharded paths) executed BOTH branches — the full
    #: 32768-row sweep ran for every lane and anti-scaled the batch tail.
    max_cluster_hypotheses: int = 8192
    max_pose_clusters: int = 2048     #: pose bins kept after clustering
    max_penetration_tests: int = 8192   #: compacted penetration point-tests

    # ----- ICP refinement (new vs reference; BASELINE.json configs) -----
    icp_iters: int = 20
    icp_max_corr_factor: float = 4.0  # x average_spacing correspondence cutoff
    enable_icp: bool = False          # reference has no ICP; off by default

    # ----- tight-radius rescore (framework addition; pipeline.py) -----
    #: re-rank the top-K coarse candidates by an exact oriented overlap at
    #: ``rescore_radius_factor x average_spacing``.  The reference's
    #: dsd-radius overlap argmax cannot tell an aliasing pose over
    #: repetitive structure from the true pose (both pass the loose
    #: radius); a tight radius can, because an alias cannot align
    #: structure that does not correspond (cluster-centroid poses are
    #: plane-fit accurate, so no per-candidate ICP is needed before the
    #: tight test).  Only the argmax among the top-K changes — the coarse
    #: reference score still ranks.  0 disables (reference-exact final
    #: ranking).
    #: K counts POSE-DISTINCT modes (greedy bound-score order, skipping
    #: candidates within the clustering tolerances of a picked pose) —
    #: plain top-K fills with near-duplicates of one family; measured:
    #: the true pose ranked 9th among distinct modes on a lattice scene,
    #: so K=8 missed it
    rescore_top_k: int = 16
    rescore_radius_factor: float = 2.0
    #: short per-candidate re-centering ICP before the tight test (see
    #: pipeline.py — family representatives chosen by the dilated bound
    #: can sit off-center; without re-centering the tight test punishes
    #: them and can overturn a correct coarse argmax)
    rescore_icp_iters: int = 3
    #: re-centering ICP uses every n-th downsampled source point as a
    #: correspondence query.  Point-to-plane Gauss-Newton at 8k
    #: correspondences is statistically indistinguishable from 16k for a
    #: 6-DoF fit; the NN passes are the rescore's dominant FLOPs (the
    #: K modes x iters x |src| x |tgt| distance volume), so 2 halves the
    #: rescore's ICP cost.  1 restores exhaustive correspondences.
    rescore_icp_subsample: int = 2
    #: rescore divides aligned counts by the CO-VISIBLE count (source
    #: points inside the target's dilated occupancy at length_threshold)
    #: instead of cloud size — partial-overlap poses are not taxed for
    #: regions the target never observed (see pipeline.py).  The floor
    #: (fraction of min cloud size) stops sliver poses gaming the ratio.
    rescore_covis_floor: float = 0.25

    # derived helpers ------------------------------------------------------
    def derived(self, average_spacing: float) -> "DerivedParams":
        length_threshold = self.length_factor * average_spacing
        return DerivedParams(
            average_spacing=average_spacing,
            down_sample_distance=self.downsample_factor * average_spacing,
            length_threshold=length_threshold,
            angle_threshold=self.angle_threshold,
            cos_angle_threshold=math.cos(self.angle_threshold),
            # scale = lengthThreshold / cos(pi/2 - angle)  (plade.cpp:56)
            scale=length_threshold / math.cos(math.pi / 2 - self.angle_threshold),
        )


@dataclasses.dataclass(frozen=True)
class DerivedParams:
    """Scalars derived from the source cloud's average spacing
    (reference: plade.cpp:41-56)."""
    average_spacing: float
    down_sample_distance: float
    length_threshold: float
    angle_threshold: float
    cos_angle_threshold: float
    scale: float


DEFAULT_CONFIG = PladeConfig()
