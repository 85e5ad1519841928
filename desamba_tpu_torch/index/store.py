"""On-disk index format: a directory of .npy arrays + meta.json.

Flat arrays load straight into numpy (host engines) or torch tensors
(device engine) with zero parsing. ``index_from_arrays`` carries an index
built by the JAX package (its fields as ``dataclasses.asdict``) into this
package's ``IndexData``, so both packages can run on one index.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .build import IndexData

_ARRAYS = [
    "row_char",
    "row_pos",
    "rank",
    "hash13",
    "uni_len",
    "uni_ref_list",
    "uni_start",
    "rp_global_off",
    "rp_ref_id",
    "rp_dir",
    "ref_bin",
    "ref_len",
    "ref_off",
    "ekmer0",
    "ekmer1",
]

_META = [
    "dollar_pos",
    "n_uni",
    "text_len",
    "e_kmer_size",
    "len_e_kmer",
    "e_hash_mask",
    "single_base_max",
]


def save_index(idx: IndexData, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in _ARRAYS:
        np.save(os.path.join(out_dir, name + ".npy"), getattr(idx, name))
    meta = {k: int(getattr(idx, k)) for k in _META}
    meta["ref_name"] = idx.ref_name
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_index(in_dir: str) -> IndexData:
    with open(os.path.join(in_dir, "meta.json")) as f:
        meta = json.load(f)
    kw = {name: np.load(os.path.join(in_dir, name + ".npy")) for name in _ARRAYS}
    kw["ref_name"] = meta.pop("ref_name")
    kw.update(meta)
    return IndexData(**kw)


def index_from_arrays(fields: dict) -> IndexData:
    """This package's IndexData from another IndexData's fields (numpy
    arrays, ints and the name list, e.g. ``dataclasses.asdict`` of the JAX
    package's). Every field without a default must be present, and no
    unknown one may be."""
    names = {f.name for f in dataclasses.fields(IndexData)}
    required = {f.name for f in dataclasses.fields(IndexData)
                if f.default is dataclasses.MISSING}
    if not required <= set(fields) <= names:
        raise ValueError(
            f"index fields: missing {sorted(required - set(fields))}, "
            f"unknown {sorted(set(fields) - names)}")
    return IndexData(**fields)
