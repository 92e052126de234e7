"""Per-ZMW result status taxonomy.

Failures are *data*, not crashes: every input ZMW terminates in exactly one
status, and the report counts must sum exactly (reference contract:
reference docs, faq/reports-aux-files.md:10-11,143-159).

The enum order matches the documented ``ccs_report.txt`` ordering
(reports-aux-files.md:24-45) so report generation can iterate the enum.
"""

from __future__ import annotations

import enum


class ZmwStatus(enum.IntEnum):
    """Status of one processed ZMW (reports-aux-files.md:143-159)."""

    SUCCESS = 0
    # --- exclusive failure causes, in ccs_report.txt order ---
    POOR_SNR = 1                 # all subreads below --min-snr
    NO_SUBREADS = 2              # all subreads dropped by median-length filter
    TOO_FEW_PASSES = 3           # fewer than --min-passes full-length subreads
    HETERODUPLEXES = 4           # single-strand artifacts (>20bp strand diff)
    COVERAGE_DROPS = 5           # coverage drops vs draft -> unreliable polish
    INSUFFICIENT_SPANS = 6       # not enough subreads aligned draft end-to-end
    TOO_FEW_PASSES_AFTER_DRAFT_ALIGNMENT = 7  # <min-passes FL reads aligned to draft
    DRAFT_FAILURE = 8            # subreads do not agree on a draft
    TOO_LONG = 9                 # draft longer than --max-length
    TOO_SHORT = 10               # draft shorter than --min-length
    TOO_MANY_UNUSABLE = 11       # too many subreads dropped while polishing
    EMPTY_WINDOW_DURING_POLISHING = 12  # a window has no coverage
    NON_CONVERGENT = 13          # polish iteration cap hit
    ADAPTER_CONCATENATION = 14   # read is a concatenation of the adapter
    ADAPTER_PALINDROME = 15      # miscalled adapter w/ revcomp insert
    ADAPTER_RESIDUE = 16         # adapter sequence close to either end
    FULL_LENGTH_SUBREAD = 17     # fail-read w/ FL subread, no consensus (fail_reads.bam)
    CONTROL_FAILURE = 18         # spike-in control that failed polishing
    CONTROL_SUCCESS = 19         # spike-in control that passed polishing
    POOR_QUALITY = 20            # rq below --min-rq
    EXCEPTION_THROWN = 21        # rare implementation errors
    # --- shortcut (not a failure; --all low-pass path) ---
    LOW_PASS_SHORTCUT = 22       # ZMW skipped polishing (mode --all)

    @property
    def is_failure(self) -> bool:
        return self not in (ZmwStatus.SUCCESS, ZmwStatus.LOW_PASS_SHORTCUT)


# Human-readable ccs_report.txt row labels, in file order
# (reports-aux-files.md:24-45).
REPORT_LABELS: dict[ZmwStatus, str] = {
    ZmwStatus.POOR_SNR: "Below SNR threshold",
    ZmwStatus.NO_SUBREADS: "Median length filter",
    ZmwStatus.TOO_FEW_PASSES: "Lacking full passes",
    ZmwStatus.HETERODUPLEXES: "Heteroduplex insertions",
    ZmwStatus.COVERAGE_DROPS: "Coverage drops",
    ZmwStatus.INSUFFICIENT_SPANS: "Insufficient draft cov",
    ZmwStatus.TOO_FEW_PASSES_AFTER_DRAFT_ALIGNMENT: "Draft too different",
    ZmwStatus.DRAFT_FAILURE: "Draft generation error",
    ZmwStatus.TOO_LONG: "Draft above --max-length",
    ZmwStatus.TOO_SHORT: "Draft below --min-length",
    ZmwStatus.TOO_MANY_UNUSABLE: "Reads failed polishing",
    ZmwStatus.EMPTY_WINDOW_DURING_POLISHING: "Empty coverage windows",
    ZmwStatus.NON_CONVERGENT: "CCS did not converge",
    ZmwStatus.ADAPTER_CONCATENATION: "CCS adapter concatenation",
    ZmwStatus.ADAPTER_PALINDROME: "CCS adapter palindrome",
    ZmwStatus.ADAPTER_RESIDUE: "CCS adapter residue",
    ZmwStatus.FULL_LENGTH_SUBREAD: "ZMW with full-length subread",
    ZmwStatus.CONTROL_FAILURE: "ZMW with control failure",
    ZmwStatus.CONTROL_SUCCESS: "ZMW with control success",
    ZmwStatus.POOR_QUALITY: "CCS below minimum RQ",
    ZmwStatus.EXCEPTION_THROWN: "Unknown error",
}

N_STATUSES = len(ZmwStatus)
