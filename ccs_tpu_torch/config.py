"""CCS configuration: the reference CLI flag surface plus TPU-only knobs.

Flag names/defaults mirror the reference exactly (SURVEY.md §2.4; evidence:
reference docs, index.md:52-64, how-does-ccs-work.md, sqiie.md:33-47).
TPU-specific knobs are namespaced ``tpu_*`` so the reference surface stays
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class CcsConfig:
    # --- filtering (how-does-ccs-work.md:19-32) ---
    min_snr: float = 2.5           # --min-snr
    min_passes: int = 3            # --min-passes
    min_length: int = 10           # --min-length (draft length gate)
    max_length: int = 50000        # --max-length (0 = unlimited)
    min_rq: float = 0.99           # --min-rq
    top_passes: int = 60           # --top-passes (0 = unlimited; accuracy-vs-passes.md:49-52)
    max_insertion_size: int = 30   # --max-insertion-size (how-does-ccs-work.md:74-78)
    min_tandem_repeat_length: int = 1000  # --min-tandem-repeat-length (low-complexity.md:12)
    disable_heuristics: bool = False      # --disable-heuristics

    # --- modes ---
    mode_all: bool = False         # --all (implies min_passes=0, min_rq=0, max_length=0)
    subread_fallback: bool = False  # --subread-fallback (with --all)
    by_strand: bool = False        # --by-strand
    hd_finder: bool = False        # --hd-finder
    hifi_kinetics: bool = False    # --hifi-kinetics
    all_kinetics: bool = False     # --all-kinetics

    # --- orchestration ---
    chunk: Optional[tuple[int, int]] = None  # --chunk i/N (1-based i)
    num_threads: int = 0           # -j (0 = auto)
    batch_size: int = 1024         # --batch-size (ZMWs per device batch)
    input_buffer: int = 4          # --input-buffer (prefetch depth, batches)
    streamed: bool = False         # --streamed (BAM on stdin)

    # --- output ---
    output: str = ""               # positional out (.bam/.fastq.gz/.consensusreadset.xml)
    fastq: Optional[str] = None    # --fastq (additional FASTQ output)
    bam: Optional[str] = None      # --bam (explicit BAM output name)
    report_file: Optional[str] = None   # --report-file
    report_json: Optional[str] = None   # --report-json
    metrics_json: Optional[str] = None  # --metrics-json
    hifi_summary_json: Optional[str] = None  # --hifi-summary-json
    suppress_reports: bool = False      # --suppress-reports
    subsample_clr_perc: float = 0.0     # --subsample-clr-perc
    subsample_clr_file: Optional[str] = None  # --subsample-clr-file

    # --- logging ---
    log_level: str = "WARN"        # --log-level
    log_file: Optional[str] = None  # --log-file
    stderr_json_log: bool = False  # --stderr-json-log
    refresh_rate: float = 5.0      # --refresh-rate (progress period, seconds)

    # --- polishing internals (documented behavior, not reference flags) ---
    window_size: int = 22          # target window size (how-does-ccs-work.md:57-59)
    # Reference uses ±2 bp; our window cuts come from anchor interpolation
    # (±2 bp fuzz) instead of exact KSW2 alignments, so wider margins are
    # needed to push boundary effects out of the cores (measured: total
    # consensus error 5 -> 2 per 1800 bp going 2 -> 4; flat at 6).
    window_overlap: int = 4
    max_polish_iterations: int = 40  # NON_CONVERGENT cap
    draft_min_fraction_mapped: float = 0.5  # >50% subreads must align back to draft
                                            # (accuracy-vs-passes.md:31-39)
    heteroduplex_min_len: int = 21  # strand diff > 20 bp fails the ZMW

    # --- TPU-only knobs (namespaced; SURVEY.md §5 config row) ---
    # template buffer per window: core (<= size + repeat shift 8) + 2*overlap
    # margins + growth slack for insertion mutations during polish. The
    # scorer's loops run to each 128-window block's max tlen / live-lane
    # count (SMEM scalars), so the static caps only size scratch — actual
    # kernel time tracks the real window sizes (~30), not the caps.
    tpu_window_tpl_cap: int = 44
    tpu_window_read_cap: int = 39      # padded read-slice length per window
                                       # (sets the kernel sublane extent
                                       # S = R+1 rounded to 8: 39 -> S=40;
                                       # every bridge vec-op scales with S,
                                       # and window slices are <= ~38 bases
                                       # so 47 was pure padding waste)
    tpu_window_coverage_cap: int = 32  # max subread slices polished per window
    tpu_polish_k: int = 12             # candidate positions scored per polish
                                       # iteration (legacy dense-loop knob)
    # fixed-shape bucket grid: every device polish call uses one of these
    # (window count x coverage lanes) shapes, so a full run compiles a small
    # closed set of programs (SURVEY §7 hard-part 5)
    tpu_window_buckets: tuple[int, ...] = (256, 2048)
    tpu_coverage_buckets: tuple[int, ...] = (8, 16, 32)
    tpu_polish_thresh: float = 0.02    # min LL gain to accept a mutation
                                       # (must exceed device fp-reduction noise)
    tpu_mesh_shape: Optional[tuple[int, ...]] = None  # None = all local devices
    tpu_resume_dir: Optional[str] = None     # checkpoint/resume directory
                                             # (batch watermarks, SURVEY §5)
    tpu_control_fasta: Optional[str] = None  # spike-in control reference
                                             # (fail-reads.md 0x2); falls back
                                             # to $SMRT_CHEMISTRY_BUNDLE_DIR/controls.fasta
    tpu_band_width: int = 128          # banded full-length alignment band
    tpu_tail_bucket: int = 128         # in-jit compaction cascade: the
                                       # polish loop gathers still-active
                                       # windows into sub-batches (B/2, B/8,
                                       # this) as they fit, so re-score cost
                                       # tracks the active count (measured
                                       # best at 128 on v5e)
    tpu_use_pw: bool = True            # condition the polisher on pulse
                                       # widths when the input carries them
                                       # (how-does-ccs-work.md:88-95)
    tpu_prepare_processes: bool = True  # -j pool uses worker PROCESSES for
                                        # the host prepare phase (the GIL
                                        # serializes ~40% of prepare under
                                        # threads); 0 = thread pool
    tpu_profile_dir: Optional[str] = None  # write a jax.profiler trace of
                                           # the run here (SURVEY §5 tracing)
    tpu_dc_polish: bool = False        # learned low-QV window refinement
                                       # after Arrow (the Revio DeepConsensus
                                       # stage, revio.md:29-53); needs a
                                       # model (built-in dc_v0 or
                                       # $SMRT_CHEMISTRY_BUNDLE_DIR/dc_model.npz)
    tpu_dc_qv_thresh: float = 25.0     # windows under this mean QV are
                                       # "low-quality" and get refined
                                       # (the 30-70% selection, revio.md:36)

    def resolve_mode_all(self) -> "CcsConfig":
        """--all implies --min-passes 0 --min-rq 0 --max-length 0 (mode-all.md:15-17)."""
        if not self.mode_all:
            return self
        return dataclasses.replace(self, min_passes=0, min_rq=0.0, max_length=0)
