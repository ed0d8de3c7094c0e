"""scripts/bench_flash.py's ``--diagnose`` variants: every text a variant
replaces is still in the source (or header) it names, so each variant
builds what its name says.  The script exits on a missing text only once it
runs on a card; this holds the tables to the sources on the CPU.
"""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "analytics_zoo_torch", "csrc")


def _bench_flash():
    spec = importlib.util.spec_from_file_location(
        "bench_flash", os.path.join(REPO, "scripts", "bench_flash.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)           # imports no torch at the top
    return module


BF = _bench_flash()


def _edits():
    """(table, variant, file the edit applies to, old, new) for every edit
    of the source-keyed tables, a source's own edits as (old, new) and a
    header's as (header, old, new)."""
    tables = {"DIAGNOSE_BF16": {BF.BF16_BWD: BF.DIAGNOSE_BF16},
              "DIAGNOSE_BF16_FWD": {BF.BF16_FWD: BF.DIAGNOSE_BF16_FWD},
              "WIDE_VARIANTS": BF.WIDE_VARIANTS,
              "WIDER_VARIANTS": BF.WIDER_VARIANTS}
    out = []
    for table, by_source in tables.items():
        for source, variants in by_source.items():
            for name, edits in variants.items():
                for edit in edits:
                    where, old, new = (edit if len(edit) == 3
                                       else (source + ".cu", *edit))
                    out.append((table, name, where, old, new))
    return out


EDITS = _edits()


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("table,name,where,old,new", EDITS,
                         ids=[f"{e[0]}-{e[1]}-{i}" for i, e in
                              enumerate(EDITS)])
def test_variant_text_is_in_its_source(table, name, where, old, new):
    text = _read(where)
    assert old in text, f"{table}[{name!r}]: {where} no longer holds {old!r}"
    assert text.replace(old, new) != text


@pytest.mark.parametrize("name", sorted(BF.DIAGNOSE))
def test_float32_variant_text_is_in_a_source(name):
    """``DIAGNOSE`` (the float32 forward and backward) takes each text from
    whichever of the two sources or the headers holds it."""
    old, _ = BF.DIAGNOSE[name]
    names = [BF.FWD + ".cu", BF.BWD + ".cu"] + sorted(
        n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    assert any(old in _read(n) for n in names), name


def test_every_table_has_variants():
    assert {e[0] for e in EDITS} == {"DIAGNOSE_BF16", "DIAGNOSE_BF16_FWD",
                                     "WIDE_VARIANTS", "WIDER_VARIANTS"}
    # the variants held bit-identical to the current build are variants
    assert {t[len("diag_"):] for t in BF.BF16_SAME} <= set(BF.DIAGNOSE_BF16)
