"""Prometheus exposition-format primitives (DESIGN.md §11).

``Histogram`` is the fixed-bucket latency histogram ``ServingMetrics``
renders under ``/stats``; ``format_value`` is the one canonical number
formatter (floats render via ``repr`` — exact ``float()`` round-trip,
no ``0.30000000000000004`` drift from ad-hoc ``str()`` calls);
``parse_exposition`` is a strict scraper-side parser used by the
round-trip test — if it accepts the output, a real Prometheus scraper
will too.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DEFAULT_LATENCY_BUCKETS_S", "Histogram", "format_value",
           "render_family", "parse_exposition"]

# Fixed latency buckets (seconds): 0.5 ms .. 10 s, roughly 1-2.5-5 per
# decade — wide enough that the observed 4.9 s serving p99 lands inside
# the ladder, not in +Inf.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def format_value(v) -> str:
    """Canonical sample-value rendering: bools as 1/0, integers plain,
    floats via ``repr`` (shortest string that round-trips through
    ``float`` — what the Go exposition writer does), NaN/±Inf in the
    exposition spellings."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))          # 3.0 -> "3": scrapers parse either
    return repr(f)


class Histogram:
    """Fixed-bucket cumulative histogram (the Prometheus model: bucket
    counts are cumulative, ``le`` upper bounds, an implicit +Inf).
    ``observe`` is O(buckets) with no allocation — cheap enough for the
    per-request latency path; callers serialize access (ServingMetrics
    holds its own lock)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram buckets must be sorted ascending")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf last
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """[(le_label, cumulative_count), ...] ending with +Inf."""
        out: List[Tuple[str, int]] = []
        running = 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            out.append((format_value(bound), running))
        out.append(("+Inf", self.count))
        return out

    def sample_lines(self, family: str, labels: str = "") -> List[str]:
        """The ``<family>_bucket``/``_sum``/``_count`` sample lines for
        one label set (``labels`` like ``op="topk"`` — no braces)."""
        sep = "," if labels else ""
        lines = [
            f'{family}_bucket{{{labels}{sep}le="{le}"}} {c}'
            for le, c in self.cumulative()]
        lab = f"{{{labels}}}" if labels else ""
        lines.append(f"{family}_sum{lab} {format_value(self.total)}")
        lines.append(f"{family}_count{lab} {self.count}")
        return lines


def render_family(family: str, ftype: str, help_text: str,
                  sample_lines: List[str]) -> List[str]:
    """One exposition block: ``# HELP`` + ``# TYPE`` + samples."""
    return [f"# HELP {family} {help_text}",
            f"# TYPE {family} {ftype}"] + sample_lines


# -- strict scraper-side parser ------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r"\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"$')

_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _family_of(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def parse_exposition(text: str) -> Dict[str, object]:
    """Parse (and validate) Prometheus text exposition format.

    Returns ``{"samples": [(name, labels_dict, value_float)],
    "types": {family: type}, "helps": {family: text}}``.  Raises
    ``ValueError`` on anything a real scraper would reject: malformed
    sample lines, bad label syntax, unparseable values, unknown TYPE
    keywords, or a duplicate TYPE line for one family.  Additionally
    enforces (as our own output contract) that every sample's family
    carries a TYPE line, and that histogram ``_bucket`` series are
    cumulative-monotone and consistent with ``_count``.
    """
    samples: List[Tuple[str, Dict[str, str], float]] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue                       # plain comment
            kind, family = parts[1], parts[2]
            if not _NAME_RE.match(family):
                raise ValueError(f"line {lineno}: bad metric name in "
                                 f"{kind}: {family!r}")
            if kind == "HELP":
                helps[family] = parts[3] if len(parts) > 3 else ""
            else:
                ftype = parts[3].strip() if len(parts) > 3 else ""
                if ftype not in _TYPES:
                    raise ValueError(
                        f"line {lineno}: unknown TYPE {ftype!r}")
                if family in types:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {family}")
                types[family] = ftype
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body:
            for part in _split_labels(body, lineno):
                lm = _LABEL_RE.match(part)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: malformed label {part!r}")
                labels[lm.group(1)] = lm.group(2)
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {lineno}: unparseable value "
                             f"{m.group('value')!r}") from None
        samples.append((m.group("name"), labels, value))
    for name, _, _ in samples:
        if _family_of(name) not in types and name not in types:
            raise ValueError(f"sample {name!r} has no # TYPE line")
    _check_histograms(samples, types)
    return {"samples": samples, "types": types, "helps": helps}


def _split_labels(body: str, lineno: int) -> List[str]:
    """Split ``a="x",b="y"`` on commas outside quotes."""
    parts: List[str] = []
    cur: List[str] = []
    in_str = False
    escape = False
    for ch in body:
        if escape:
            cur.append(ch)
            escape = False
        elif ch == "\\":
            cur.append(ch)
            escape = True
        elif ch == '"':
            cur.append(ch)
            in_str = not in_str
        elif ch == "," and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if in_str:
        raise ValueError(f"line {lineno}: unterminated label string")
    if cur:
        parts.append("".join(cur))
    return parts


def _check_histograms(samples, types) -> None:
    """Bucket series must be cumulative-monotone in ``le`` and agree
    with their ``_count`` sample (per label set)."""
    series: Dict[Tuple[str, tuple], List[Tuple[float, float]]] = {}
    counts: Dict[Tuple[str, tuple], float] = {}
    for name, labels, value in samples:
        family = _family_of(name)
        if types.get(family) != "histogram":
            continue
        key_labels = tuple(sorted(
            (k, v) for k, v in labels.items() if k != "le"))
        if name.endswith("_bucket"):
            series.setdefault((family, key_labels), []).append(
                (float(labels.get("le", "inf")), value))
        elif name.endswith("_count"):
            counts[(family, key_labels)] = value
    for key, buckets in series.items():
        buckets.sort(key=lambda t: t[0])
        last = 0.0
        for le, c in buckets:
            if c < last:
                raise ValueError(
                    f"histogram {key[0]} buckets not cumulative")
            last = c
        if key in counts and buckets and buckets[-1][1] != counts[key]:
            raise ValueError(
                f"histogram {key[0]} +Inf bucket != _count")
