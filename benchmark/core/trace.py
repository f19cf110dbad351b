"""The device trace of a measured window and the arithmetic every reader
shares: the union of intervals, the idle share, device time a step by
kernel family, and the breakdown the result line carries.

The kernel families and the name patterns are copied from the port's
``tactile_gan_torch/utils/profiling.py`` (``OWN_FAMILIES``,
``LIBRARY_CONV``, ``busy_us``), so that no change to the program moves how
the benchmark sorts its kernels: the port's own kernels are matched first,
as whole identifiers; a name holding one of the library substrings is a
library conv (cuDNN's and cuBLAS's convolutions and GEMMs); everything else
is "other".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PEAK_FLOPS = 989e12        # H100 SXM, dense bf16 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published

OWN_FAMILIES = (
    ("kernel_a", ("in_act_fwd_kernel",)),
    ("kernel_c", ("in_act_bwd_kernel",)),
    ("kernel_b", ("conv3x3_fwd_sm90_kernel", "conv3x3_f32_kernel")),
    ("kernel_b_dx", ("conv3x3_dgrad_sm90_kernel", "conv3x3_dgrad_f32_kernel")),
    ("kernel_d", ("conv3x3_wgrad_sm90_kernel", "wgrad_f32_kernel",
                  "wgrad_reduce_kernel")),
    ("kernel_e", ("conv3x3_p1_sm90_kernel",)),
    ("conv3x3_tail", ("conv3x3_p1_bf16_kernel", "conv3x3_p1_f32_kernel")),
)
_OWN = [(fam, re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(keys) + r")\b"))
        for fam, keys in OWN_FAMILIES]
LIBRARY_CONV = ("conv", "xmma", "cudnn", "cutlass", "gemm", "sm90_", "sm80_")
BREAKDOWN_ENTRIES = 10
GAPS_ATTRIBUTED = 2000  # the longest idle gaps named by the host's activity


def kernel_family(name: str) -> str:
    for family, pattern in _OWN:
        if pattern.search(name):
            return family
    low = name.lower()
    if any(k in low for k in LIBRARY_CONV):
        return "library_conv"
    return "other"


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The (start, end) gaps between the union's pieces, longest first."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return sorted(gaps, key=lambda g: g[0] - g[1])


@dataclasses.dataclass
class Trace:
    """Device operations (name, start_s, end_s) and host spans (name,
    start_s, end_s) of a traced window of ``window_s`` seconds holding
    ``steps`` training steps."""
    device_ops: List[Tuple[str, float, float]]
    host_spans: List[Tuple[str, float, float]]
    window_s: float
    steps: int
    _memo: dict = dataclasses.field(default_factory=dict, repr=False)

    def busy_s(self) -> float:
        if "busy" not in self._memo:
            self._memo["busy"] = union_length(
                (s, e) for _, s, e in self.device_ops)
        return self._memo["busy"]

    def family_s(self) -> Dict[str, float]:
        """Device seconds by kernel family."""
        out: Dict[str, float] = {}
        for name, secs in self.by_name().items():
            fam = kernel_family(name)
            out[fam] = out.get(fam, 0.0) + secs
        return out

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation name."""
        if "by_name" not in self._memo:
            out: Dict[str, float] = {}
            for name, s, e in self.device_ops:
                out[name] = out.get(name, 0.0) + (e - s)
            self._memo["by_name"] = out
        return self._memo["by_name"]

    def ms_per_step(self, families: Iterable[str]) -> Optional[float]:
        """Device ms a step of ``families``; None where none ran."""
        by = self.family_s()
        hits = [by[f] for f in families if f in by]
        if not hits or self.steps == 0:
            return None
        return sum(hits) / self.steps * 1e3

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])
        gaps = idle_gaps([(s, e) for _, s, e in self.device_ops])
        gaps = gaps[:GAPS_ATTRIBUTED]
        by_host: Dict[str, float] = {}
        spans = sorted(self.host_spans, key=lambda sp: sp[1])
        starts = np.array([sp[1] for sp in spans])
        for a, b in gaps:
            name = _covering(spans, starts, (a + b) / 2)
            by_host[name] = by_host.get(name, 0.0) + (b - a)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:120], v] for n, v in
                               ops[:BREAKDOWN_ENTRIES]],
                "idle_gaps": [[n[:120], v] for n, v in
                              idle[:BREAKDOWN_ENTRIES]]}


def _covering(spans, starts, t: float, reach: int = 5000) -> str:
    """The innermost host span covering time ``t``: of the covering spans,
    the one that started last (spans sorted by start)."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(-1, i - reach), -1):
        if spans[j][2] >= t:
            return spans[j][0]
    return "(no host span)"


def from_profiler(prof, window_s: float, steps: int) -> Trace:
    """Read a finished ``torch.profiler.profile``'s raw events: device
    operations (kernels, copies, sets; not user annotations) and host
    spans (operators, runtime calls, the harness's own ranges)."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    raw = {cuda: [], cpu: []}
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == cpu or (kind == cuda and not ev.is_user_annotation()):
            raw[kind].append((ev.name(), ev.start_ns(), ev.duration_ns()))
    # Seconds from the first event: nanoseconds since the epoch would lose
    # their last digits in a float.
    base = min((r[1] for rows in raw.values() for r in rows), default=0)

    def spans(rows):
        return [(name, (s - base) * 1e-9, (s - base + d) * 1e-9)
                for name, s, d in rows]
    return Trace(spans(raw[cuda]), spans(raw[cpu]), window_s, steps)
