"""Factory-string parser: FAISS index_factory grammar → index model graph.

The reference forwards the index-type string straight to
``faiss::index_factory(dim, desc, metric)`` (src/faiss_extension.cpp:154-155),
so the observable surface is the factory grammar itself.  We parse the subset
the reference exercises (its tests and benchmarks use: ``Flat``,
``IDMap,Flat``, ``IDMap,IVF1,Flat``, ``HNSW16``, ``IDMap,HNSW32``,
``IDMap,HNSW128,Flat``, ``IVF2048_HNSW128,Flat`` — SURVEY.md §4,§6) into a
graph of device-native index models:

    desc        := [prefix ","]* [transform ","]* component ["," encoding]
                   ["," suffix]
    prefix      := "IDMap" | "IDMap2"
    transform   := "PCA"[R|W]n | "OPQ"m["_"dout] | "RR"[n] | "ITQ"[n] | "Pad"n
                   | "L2norm"
    component   := "Flat" | "HNSW"[M] | "NSG"[R] | "IVF"nlist["_" quantizer]
                   | "IVF"nlist"("quantizer-desc")"   (parenthesized form)
                   | "IMI2x"nbits (product coarse quantizer, nlist=4^nbits)
                   | "PQ"M["x"nbits] | "RQ"M"x"nbits | "LSH"[nbits]["r"]["t"]
    quantizer   := "Flat" | "HNSW"[M] | "PQ"M
    encoding    := "Flat" | "PQ"M["x"nbits] | "RQ"M"x"nbits | "SQ8"
                   | "SQ4" | "SQ6" | "SQfp16" | "SQbf16"
                   (PQ and SQ encodings valid both standalone and as IVF storage)
    suffix      := "RFlat"  (exact re-rank wrapper, IndexRefineFlat)

Unsupported strings raise InvalidInputError mirroring FAISS's
"could not parse index string" failure mode.
"""

from __future__ import annotations

import re

from .errors import InvalidInputError
from .metrics import Metric
from .models.base import Index
from .models.flat import FlatIndex
from .models.idmap import IDMapIndex

_HNSW_RE = re.compile(r"^HNSW(\d*)$")
_IVF_RE = re.compile(r"^IVF(\d+)(?:_(.+))?$")
_IVF_PAREN_RE = re.compile(r"^IVF(\d+)\((.+)\)$")
_PQ_RE = re.compile(r"^PQ(\d+)(?:x(\d+))?$")
_SQ_RE = re.compile(r"^SQ(8|4|6|fp16|bf16)$")
_LSH_RE = re.compile(r"^LSH(\d*)(r?)(t?)$")
_PCA_RE = re.compile(r"^PCA(R|W)?(\d+)$")
_OPQ_RE = re.compile(r"^OPQ(\d+)(?:_(\d+))?$")
_RR_RE = re.compile(r"^RR(\d*)$")
_ITQ_RE = re.compile(r"^ITQ(\d*)$")
_PAD_RE = re.compile(r"^Pad(\d+)$")
_NSG_RE = re.compile(r"^NSG(\d*)$")
_IMI_RE = re.compile(r"^IMI2x(\d+)$")
_RQ_RE = re.compile(r"^RQ(\d+)x(\d+)$")


def _parse_transform(tok: str, d: int):
    """Transform-prefix tokens (faiss VectorTransform grammar subset):
    PCAn / PCARn / PCAWn, OPQm[_dout], RR[n], ITQ[n], Padn, L2norm.  Returns None
    for non-transform tokens."""
    from .transforms import (ITQTransform, L2NormTransform, OPQMatrix,
                             PCAMatrix, RandomRotationMatrix)

    if tok == "L2norm":
        return L2NormTransform(d)
    m = _PCA_RE.match(tok)
    if m:
        return PCAMatrix(d, int(m.group(2)),
                         random_rotation=m.group(1) == "R",
                         whiten=m.group(1) == "W")
    m = _OPQ_RE.match(tok)
    if m:
        d_out = int(m.group(2)) if m.group(2) else None
        return OPQMatrix(d, int(m.group(1)), d_out)
    m = _RR_RE.match(tok)
    if m:
        return RandomRotationMatrix(d, int(m.group(1)) if m.group(1)
                                    else None)
    m = _ITQ_RE.match(tok)
    if m:
        return ITQTransform(d, int(m.group(1)) if m.group(1) else None)
    m = _PAD_RE.match(tok)
    if m:
        from .transforms import PadTransform

        return PadTransform(d, int(m.group(1)))
    return None


def _parse_error(desc: str, detail: str = "") -> InvalidInputError:
    extra = f" ({detail})" if detail else ""
    return InvalidInputError(f"could not parse index string {desc}{extra}")


def _split_components(desc: str) -> list[str]:
    """Split a factory description on top-level commas, respecting the
    parenthesized coarse-quantizer form (``IVF4096(IVF256,Flat),PQ8``)."""
    parts, depth, cur = [], 0, []
    for ch in desc:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise _parse_error(desc, "unbalanced parentheses")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise _parse_error(desc, "unbalanced parentheses")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def build_index(d: int, desc: str, metric: Metric,
                metric_arg: float = 0.0) -> Index:
    """Build the index graph for a factory description."""
    parts = _split_components(desc)
    if not parts:
        raise _parse_error(desc, "empty description")

    idmap = 0
    while parts and parts[0] in ("IDMap", "IDMap2"):
        idmap += 1
        parts.pop(0)
    if not parts:
        raise _parse_error(desc, "no index component after IDMap")

    refine = False
    if parts[-1] == "RFlat":
        # faiss::IndexRefineFlat suffix (exact re-rank of the base's
        # candidates on raw vectors).
        refine = True
        parts.pop()
        if not parts:
            raise _parse_error(desc, "RFlat needs a base index")

    transforms = []
    d_cur = d
    while parts:
        t = _parse_transform(parts[0], d_cur)
        if t is None:
            break
        transforms.append(t)
        d_cur = t.d_out
        parts.pop(0)
    if not parts:
        raise _parse_error(desc, "no index component after transforms")

    index = _build_component(d_cur, parts, metric, metric_arg, desc)
    if transforms:
        from .models.pretransform import PreTransformIndex

        index = PreTransformIndex(transforms, index)
    if refine:
        from .models.refine import RefineFlatIndex

        index = RefineFlatIndex(index)
    if idmap:
        index = IDMapIndex(index)
    index.factory_desc = desc
    return index


def _build_component(d, parts, metric, metric_arg, desc) -> Index:
    head = parts[0]
    rest = parts[1:]

    if head == "Flat":
        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return FlatIndex(d, metric, metric_arg)

    m = _HNSW_RE.match(head)
    if m:
        from .models.hnsw import HNSWIndex

        M = int(m.group(1)) if m.group(1) else 32
        storage = rest[0] if rest else "Flat"
        if rest and rest[0] not in ("Flat",) and not _PQ_RE.match(rest[0]) \
                and not _SQ_RE.match(rest[0]):
            raise _parse_error(desc, f"unsupported HNSW storage {rest[0]}")
        if len(rest) > 1:
            raise _parse_error(desc,
                               f"unexpected trailing components {rest[1:]}")
        return HNSWIndex(d, metric, metric_arg, M=M, storage=storage)

    m = _NSG_RE.match(head)
    if m:
        from .models.hnsw import NSGIndex

        R = int(m.group(1)) if m.group(1) else 32
        storage = rest[0] if rest else "Flat"
        if rest and rest[0] not in ("Flat",) and not _PQ_RE.match(rest[0]) \
                and not _SQ_RE.match(rest[0]):
            raise _parse_error(desc, f"unsupported NSG storage {rest[0]}")
        if len(rest) > 1:
            raise _parse_error(desc,
                               f"unexpected trailing components {rest[1:]}")
        return NSGIndex(d, metric, metric_arg, M=R, storage=storage)

    m = _IVF_PAREN_RE.match(head) or _IVF_RE.match(head)
    if m:
        from .models.ivf import IVFIndex

        nlist = int(m.group(1))
        quant_desc = m.group(2) or "Flat"
        quantizer = build_index(d, quant_desc, metric, metric_arg)
        encoding = rest[0] if rest else "Flat"
        if len(rest) > 1:
            raise _parse_error(desc, f"unexpected trailing components {rest[1:]}")
        return IVFIndex(d, metric, metric_arg, nlist=nlist,
                        quantizer=quantizer, encoding=encoding)

    m = _IMI_RE.match(head)
    if m:
        from .models.ivf import IMIIndex

        nbits = int(m.group(1))
        quantizer = FlatIndex(d, metric, metric_arg)
        encoding = rest[0] if rest else "Flat"
        if len(rest) > 1:
            raise _parse_error(desc, f"unexpected trailing components {rest[1:]}")
        return IMIIndex(d, metric, metric_arg, nbits=nbits,
                        quantizer=quantizer, encoding=encoding)

    m = _PQ_RE.match(head)
    if m:
        from .models.pq import PQIndex

        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        M = int(m.group(1))
        nbits = int(m.group(2)) if m.group(2) else 8
        return PQIndex(d, metric, metric_arg, M=M, nbits=nbits)

    m = _RQ_RE.match(head)
    if m:
        from .models.rq import RQIndex

        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return RQIndex(d, metric, metric_arg, M=int(m.group(1)),
                       nbits=int(m.group(2)))

    m = _LSH_RE.match(head)
    if m:
        from .models.lsh import LSHIndex

        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return LSHIndex(d, metric, metric_arg,
                        nbits=int(m.group(1)) if m.group(1) else None,
                        rotate=bool(m.group(2)),
                        train_thresholds=bool(m.group(3)))

    if head in ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16"):
        from .models.sq import SQIndex

        if rest:
            raise _parse_error(desc, f"unexpected trailing components {rest}")
        return SQIndex(d, metric, metric_arg, qtype=head)

    raise _parse_error(desc, f"unknown component {head}")
