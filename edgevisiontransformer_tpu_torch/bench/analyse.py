"""Profiling-CSV analyser (port of ``edgevisiontransformer_tpu/bench/analyse.py``,
itself a functional port of the reference's ``analyse.py``).

Reads the profile CSVs that ``bench/profile.py`` writes and original
TFLite phone CSVs (same section schema).  Returns data structures; a CLI
prints them in the reference's output format.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Tuple


def _replace_flex(name: str, model_type: str) -> str:
    """Rename Flex-delegate rows per model family (reference analyse.py:11-22)."""
    op = name.split(":")[0].split("/")[-1].lower()
    if model_type == "swin":
        if "transpose" in op:
            return "TRANSPOSE"
        if "add" in op:
            return "ADDv2"
        if "roll" in op:
            return "ROLL"
        if "erf" in op:
            return "ERF"
    if model_type == "t2t_vit":
        if "einsum" in op:
            return "EINSUM"
        if "extractimagepatches" in op:
            return "EXTRACTIMAGEPATCHES"
    return "TFFLEXDELEGATE"


def read_rows(file_path: str) -> List[List[str]]:
    with open(file_path) as f:
        return [row for row in csv.reader(f)]


def find_op_wise_range(rows) -> Tuple[int, int, Dict[str, int]]:
    """Locate the op-wise section + column schema (analyse.py:25-39)."""
    schema: Dict[str, int] = {}
    begin = 0
    for i, row in enumerate(rows):
        if len(row) == 1 and "Operator-wise Profiling Info for Regular Benchmark Run" in row[0]:
            schema_row = rows[i + 2]
            schema = {schema_row[j].strip(): j for j in range(len(schema_row))}
            begin = i + 3
            break
    end = begin
    while end < len(rows) and len(rows[end]) >= len(schema):
        end += 1
    return begin, end, schema


def analyse_op(file: str, model_type: str = "deit") -> Dict[str, Dict[str, float]]:
    """Aggregate latency/% by op type (analyse.py:52-75)."""
    rows = read_rows(file)
    begin, end, schema = find_op_wise_range(rows)
    table: Dict[str, Dict[str, float]] = {}
    for row in rows[begin:end]:
        node_type = row[schema["node type"]]
        if "TfLiteFlexDelegate" in node_type:
            node_type = _replace_flex(row[schema["name"]], model_type)
        entry = table.setdefault(node_type, {"latency": 0.0, "percent": 0.0})
        entry["latency"] += float(row[schema["avg_ms"]])
        entry["percent"] += float(row[schema["%"]].rstrip("%"))
    return table


def analyse_attn_ffn(file: str, model_type: str = "deit") -> Dict[str, float]:
    """Attention-vs-FFN latency split (analyse.py:136-190).

    For our CSVs the row names carry '/attn/' or '/ffn/' directly; for
    reference-style CSVs we fall back to the layer-norm-name alternation
    heuristic the reference uses for deit/t2t.
    """
    rows = read_rows(file)
    begin, end, schema = find_op_wise_range(rows)
    attn = ffn = other = 0.0
    native_naming = any(
        "/attn/" in r[schema["name"]] or "/ffn/" in r[schema["name"]]
        for r in rows[begin:end]
    )
    if native_naming:
        for row in rows[begin:end]:
            t = float(row[schema["avg_ms"]])
            name = row[schema["name"]]
            if "/attn/" in name:
                attn += t
            elif "/ffn/" in name:
                ffn += t
            else:
                other += t
    else:
        # layer_norm alternation: rows between even/odd LN occurrences belong
        # to attention/FFN respectively (reference heuristic for deit/t2t).
        ln_count = 0
        for row in rows[begin:end]:
            t = float(row[schema["avg_ms"]])
            name = row[schema["name"]].lower()
            if "layer_norm" in name or "layernorm" in name:
                ln_count += 1
                continue
            if ln_count == 0:
                other += t
            elif ln_count % 2 == 1:
                attn += t
            else:
                ffn += t
    return {"attention_ms": attn, "ffn_ms": ffn, "other_ms": other}


def analyse_gelu_ln(file: str, model_type: str = "deit") -> Dict[str, float]:
    """GELU / LayerNorm latency shares (analyse.py:78-133).

    Our CSVs carry explicit GELU_MLP / LAYER_NORM node types; reference CSVs
    decompose GELU into 8 rows starting at a POW op (the heuristic we apply
    when explicit types are absent).
    """
    rows = read_rows(file)
    begin, end, schema = find_op_wise_range(rows)
    gelu = ln = total = 0.0
    data = rows[begin:end]
    explicit = any(r[schema["node type"]] in ("GELU", "GELU_MLP", "LAYER_NORM")
                   for r in data)
    i = 0
    while i < len(data):
        row = data[i]
        node_type = row[schema["node type"]]
        t = float(row[schema["avg_ms"]])
        total += t
        if explicit:
            if node_type == "LAYER_NORM":
                ln += t
            elif node_type == "GELU":
                # activation-only row (bench/profile.py emits fc1/gelu/fc2
                # separately) — same semantics as the reference's 8-row POW
                # decomposition, so the GELU share is directly comparable
                gelu += t
            elif node_type == "GELU_MLP":
                gelu += t  # legacy CSVs: includes the matmuls (coarser)
            i += 1
            continue
        if node_type == "POW":  # decomposed tanh-gelu: POW + next 7 rows
            for j in range(i, min(i + 8, len(data))):
                gelu += float(data[j][schema["avg_ms"]])
                if j > i:
                    total += float(data[j][schema["avg_ms"]])
            i += 8
            continue
        if "norm" in row[schema["name"]].lower():
            ln += t
        i += 1
    return {"gelu_ms": gelu, "layernorm_ms": ln, "total_ms": total}


def fetch_all_op_latency(file: str) -> List[Tuple[str, float]]:
    """Per-op latency series ordered by start timestamp (analyse.py:193-216)."""
    rows = read_rows(file)
    begin, end, schema = find_op_wise_range(rows)
    series = [
        (row[schema["name"]], float(row[schema["avg_ms"]]),
         float(row[schema["start"]]))
        for row in rows[begin:end]
    ]
    series.sort(key=lambda x: x[2])
    return [(name, ms) for name, ms, _ in series]
