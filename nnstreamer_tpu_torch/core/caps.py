"""Capabilities: the negotiation data model between pipeline pads (copied
from the JAX package's ``core/caps.py``).

Replacement for GstCaps carrying ``other/tensor(s)`` media types
(parity targets: nnstreamer:gst/nnstreamer/nnstreamer_plugin_api_impl.c:1372
``gst_tensors_caps_from_config``, :1142 ``gst_tensor_caps_can_intersect`` with
rank-flexible dimension compare, and the caps templates in
tensor_typedef.h:79-132).

A :class:`Caps` is an ordered union of :class:`CapsStruct` alternatives (order
expresses preference, as in GStreamer).  Field values may be concrete, a set of
alternatives, an inclusive range, or the wildcard ANY.  Intersection walks the
cross product preserving preference order; fixation picks the first alternative
and collapses every field to a concrete value.

Special-cased fields:
- ``dimensions`` — per-tensor rank-flexible compare ("3:224:224:1" matches
  "3:224:224"); a component of 0 in a *template* means "that dim is free".
- ``framerate`` — exact fractions; 0/1 intersects with anything.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple, Union

from .spec import TensorsSpec, dims_equal, parse_dimension, \
    split_tensor_list
from .types import TensorFormat, MIMETYPE_TENSORS


class _Any:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "ANY"


ANY = _Any()


@dataclasses.dataclass(frozen=True)
class Range:
    """Inclusive numeric range."""

    lo: Union[int, Fraction]
    hi: Union[int, Fraction]

    def contains(self, v) -> bool:
        return self.lo <= v <= self.hi

    def intersect(self, other: "Range") -> Optional["Range"]:
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        if lo > hi:
            return None
        return Range(lo, hi)

    def __repr__(self):
        return f"[{self.lo},{self.hi}]"


FieldValue = Any  # concrete | frozenset | Range | ANY


def _dim_parts(d: str) -> list:
    """Split one dim string into int components with trailing rank-end zeros
    stripped ('3:224:224:0' → [3, 224, 224]); interior 0 = free dim."""
    parts = [int(p.strip()) if p.strip() else 1 for p in d.split(":")]
    while parts and parts[-1] == 0:
        parts.pop()
    return parts


_split_dims_list = split_tensor_list


def _dims_match_template(tpl: str, concrete: str) -> bool:
    """Rank-flexible dims-list compare; interior 0 in template = free dim."""
    tl = _split_dims_list(tpl)
    cl = _split_dims_list(concrete)
    if len(tl) != len(cl):
        return False
    for td, cd in zip(tl, cl):
        tparts = _dim_parts(td)
        cdims = parse_dimension(cd)
        n = max(len(tparts), len(cdims))
        for i in range(n):
            tv = tparts[i] if i < len(tparts) else 1
            cv = cdims[i] if i < len(cdims) else 1
            if tv == 0:  # free dimension in template
                continue
            if tv != cv:
                return False
    return True


def _dims_is_template(v: str) -> bool:
    return any(p == 0 for d in _split_dims_list(v) for p in _dim_parts(d))


def _intersect_value(field: str, a: FieldValue, b: FieldValue
                     ) -> Tuple[bool, FieldValue]:
    """Returns (ok, merged)."""
    if a is ANY:
        return True, b
    if b is ANY:
        return True, a
    if field == "framerate" and not isinstance(a, (Range, frozenset)) \
            and not isinstance(b, (Range, frozenset)):
        fa, fb = Fraction(a), Fraction(b)
        if fa == 0:
            return True, fb
        if fb == 0:
            return True, fa
        return (fa == fb), fa
    if field == "dimensions" and isinstance(a, str) and isinstance(b, str):
        a_tpl, b_tpl = _dims_is_template(a), _dims_is_template(b)
        if a_tpl and not b_tpl:
            return _dims_match_template(a, b), b
        if b_tpl and not a_tpl:
            return _dims_match_template(b, a), a
        if not a_tpl and not b_tpl:
            al = _split_dims_list(a)
            bl = _split_dims_list(b)
            ok = len(al) == len(bl) and all(
                dims_equal(parse_dimension(x), parse_dimension(y))
                for x, y in zip(al, bl))
            return ok, a
        return (a == b), a  # both templates: require textual equality
    a_set = isinstance(a, frozenset)
    b_set = isinstance(b, frozenset)
    a_rng = isinstance(a, Range)
    b_rng = isinstance(b, Range)
    if a_set and b_set:
        m = a & b
        return bool(m), m if len(m) > 1 else next(iter(m), None)
    if a_set and b_rng:
        m = frozenset(v for v in a if b.contains(v))
        return bool(m), m if len(m) > 1 else next(iter(m), None)
    if b_set and a_rng:
        m = frozenset(v for v in b if a.contains(v))
        return bool(m), m if len(m) > 1 else next(iter(m), None)
    if a_set:
        return (b in a), b
    if b_set:
        return (a in b), a
    if a_rng and b_rng:
        m = a.intersect(b)
        return (m is not None), m
    if a_rng:
        return a.contains(b), b
    if b_rng:
        return b.contains(a), a
    return (a == b), a


def _is_fixed_value(field: str, v: FieldValue) -> bool:
    if v is ANY or isinstance(v, (frozenset, Range)):
        return False
    if field == "dimensions" and isinstance(v, str) and _dims_is_template(v):
        return False
    return True


def _fixate_value(field: str, v: FieldValue) -> FieldValue:
    if v is ANY:
        raise ValueError(f"cannot fixate wildcard field {field!r}")
    if isinstance(v, frozenset):
        return sorted(v, key=str)[0]
    if isinstance(v, Range):
        return v.lo
    if field == "dimensions" and isinstance(v, str) and _dims_is_template(v):
        # free dims fixate to 1
        return ",".join(
            ":".join(str(p if p != 0 else 1) for p in _dim_parts(d))
            for d in v.split(",") if d.strip())
    return v


@dataclasses.dataclass(frozen=True)
class CapsStruct:
    """One caps alternative: mimetype + constrained fields."""

    mime: str
    fields: Tuple[Tuple[str, FieldValue], ...] = ()

    @classmethod
    def make(cls, mime: str, **fields) -> "CapsStruct":
        norm = []
        for k, v in fields.items():
            if v is None:
                continue
            if isinstance(v, (list, set)) and not isinstance(v, frozenset):
                v = frozenset(v)
            norm.append((k, v))
        return cls(mime=mime, fields=tuple(sorted(norm)))

    def as_dict(self) -> Dict[str, FieldValue]:
        return dict(self.fields)

    def get(self, key: str, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default

    def intersect(self, other: "CapsStruct") -> Optional["CapsStruct"]:
        if self.mime != other.mime:
            if self.mime == "*":
                return other.intersect(CapsStruct(other.mime, self.fields))
            if other.mime == "*":
                return self.intersect(CapsStruct(self.mime, other.fields))
            return None
        a, b = self.as_dict(), other.as_dict()
        merged = {}
        for k in set(a) | set(b):
            if k in a and k in b:
                ok, mv = _intersect_value(k, a[k], b[k])
                if not ok:
                    return None
                merged[k] = mv
            else:
                merged[k] = a.get(k, b.get(k))
        return CapsStruct.make(self.mime, **merged)

    def is_fixed(self) -> bool:
        if self.mime == "*":
            return False
        return all(_is_fixed_value(k, v) for k, v in self.fields)

    def fixate(self) -> "CapsStruct":
        if self.mime == "*":
            raise ValueError("cannot fixate wildcard-mime caps")
        return CapsStruct.make(
            self.mime, **{k: _fixate_value(k, v) for k, v in self.fields})

    def __str__(self):
        f = ", ".join(f"{k}={v}" for k, v in self.fields)
        return f"{self.mime}" + (f", {f}" if f else "")


@dataclasses.dataclass(frozen=True)
class Caps:
    """Ordered union of alternatives; empty = EMPTY (negotiation failure)."""

    structs: Tuple[CapsStruct, ...] = ()

    @classmethod
    def new(cls, *structs: CapsStruct) -> "Caps":
        return cls(structs=tuple(structs))

    @classmethod
    def any_tensors(cls) -> "Caps":
        return cls.new(CapsStruct.make(MIMETYPE_TENSORS))

    @classmethod
    def any(cls) -> "Caps":
        """Wildcard caps: intersects with any mimetype."""
        return cls.new(CapsStruct.make("*"))

    @classmethod
    def from_spec(cls, spec: TensorsSpec) -> "Caps":
        """Parity: gst_tensors_caps_from_config
        (nnstreamer_plugin_api_impl.c:1372)."""
        fields = dict(format=str(spec.format), framerate=spec.rate)
        if spec.format == TensorFormat.STATIC:
            # "." separates tensors inside caps fields ("," separates the
            # fields themselves) — reference caps-string grammar, keeps
            # str(caps) round-trippable through parse_caps_string
            fields.update(num_tensors=spec.num_tensors,
                          dimensions=spec.dimensions_string(sep="."),
                          types=spec.types_string(sep="."))
        return cls.new(CapsStruct.make(MIMETYPE_TENSORS, **fields))

    def to_spec(self) -> TensorsSpec:
        """Build a TensorsSpec from fixed tensor caps."""
        if not self.structs:
            raise ValueError("empty caps")
        s = self.structs[0]
        if s.mime != MIMETYPE_TENSORS:
            raise ValueError(f"not a tensor caps: {s.mime}")
        if not s.is_fixed():
            raise ValueError(f"caps not fixed, cannot build spec: {s}")
        fmt = s.get("format", "static")
        rate = s.get("framerate", Fraction(0, 1))
        if TensorFormat.from_string(str(fmt)) != TensorFormat.STATIC:
            return TensorsSpec(format=TensorFormat.from_string(str(fmt)),
                               rate=Fraction(rate))
        dims, types = s.get("dimensions"), s.get("types")
        if dims is None or types is None:
            raise ValueError(f"static tensor caps missing dims/types: {s}")
        # caps-string parsing may have produced non-str scalars (e.g. a
        # single-component dimensions=1)
        return TensorsSpec.parse(str(dims), str(types), format="static",
                                 rate=rate)

    def intersect(self, other: "Caps") -> "Caps":
        out, seen = [], set()
        for a in self.structs:
            for b in other.structs:
                m = a.intersect(b)
                if m is not None and m not in seen:
                    seen.add(m)
                    out.append(m)
        return Caps(structs=tuple(out))

    def can_intersect(self, other: "Caps") -> bool:
        """Parity: gst_tensor_caps_can_intersect
        (nnstreamer_plugin_api_impl.c:1142)."""
        return bool(self.intersect(other).structs)

    def is_fixed(self) -> bool:
        return len(self.structs) == 1 and self.structs[0].is_fixed()

    def is_empty(self) -> bool:
        return not self.structs

    def fixate(self) -> "Caps":
        if not self.structs:
            raise ValueError("cannot fixate empty caps")
        return Caps.new(self.structs[0].fixate())

    def first(self) -> CapsStruct:
        return self.structs[0]

    def __bool__(self):
        return bool(self.structs)

    def __str__(self):
        return " ; ".join(str(s) for s in self.structs) or "EMPTY"
