"""The one resolver for the pipelines' implementation selectors.

Every ``*_impl`` knob (``RDPipeline.rd_impl``/``cfar_impl``/``topk_impl``,
``RangeDetector.detect_impl``, ``DistributedRDPipeline``) resolves here:
'auto' names the default implementation, a known name resolves to itself,
and anything else raises ``ValueError`` naming the value — a pin of an
implementation that does not exist never degrades silently into another.
"""

from __future__ import annotations

# first entry = what 'auto' resolves to
IMPLS: dict[str, tuple[str, ...]] = {
    "rd_impl": ("fft", "mxu", "planar", "fused"),
    "cfar_impl": ("xla",),
    "topk_impl": ("xla",),
    "detect_impl": ("xla",),
}


def resolve_impl(field: str, value: str) -> str:
    """Resolve one selector value ('auto' or a name in ``IMPLS[field]``)."""
    choices = IMPLS[field]
    if value == "auto":
        return choices[0]
    if value not in choices:
        raise ValueError(
            f"{field}={value!r} is not an implementation; use 'auto' or "
            f"one of {', '.join(repr(c) for c in choices)}"
        )
    return value
