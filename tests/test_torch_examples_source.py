"""The port's example suite is the JAX package's, script for script.

Every script under `examples/` has a copy under
`asset_asrl_torch/examples/` at the same relative path.  After the import
lines of both are normalised (the package name, a sibling example
imported relative to the package, the alignment of a parenthesised
import's continuation lines and its `noqa` mark), the two must be equal
line for line, except for the JAX lines that `REMOVED` lists by file and
line number, each with its reason.  So a mirror that calls a copy at a
JAX test's arguments solves the JAX test's problem."""

import difflib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "examples"
PORT = ROOT / "asset_asrl_torch" / "examples"
SCRIPTS = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))

PATH_EDIT = ("the JAX script puts `examples/` (and the repo) on sys.path to "
             "import a sibling; the copy is a module of "
             "`asset_asrl_torch.examples` and imports it relative to the "
             "package, so the edit and the names it used go")
# JAX script -> the line numbers of its lines that the copy drops, and why
REMOVED = {
    "MinimumTimeToClimb.py": ([8, 9, 12, 13, 14], PATH_EDIT),
    "MeshRefinement/Delta3Launch.py": ([5, 6, 7, 8], PATH_EDIT),
    "MeshRefinement/Reentry.py": ([5, 6, 7, 8], PATH_EDIT),
    "UpdatedInterface/BettsLowThrust.py": ([6, 7, 10, 11, 12, 13], PATH_EDIT),
    "UpdatedInterface/Delta3Launch.py": ([6, 7, 10, 11, 12, 13], PATH_EDIT),
    "UpdatedInterface/MinimumTimeToClimb.py": ([6, 7, 10, 11, 12, 13],
                                               PATH_EDIT),
    "UpdatedInterface/MinimumTimeToClimbTables.py": ([5, 6, 8, 9], PATH_EDIT),
}


def normalised(text):
    """The script's lines with its import lines normalised."""
    out, cont = [], False
    for line in text.splitlines():
        line = line.replace("asset_asrl_tpu", "asset_asrl_torch")
        start = re.match(r"(from|import) ", line)
        if start:
            line = re.sub(r"^from \.+(\w)", r"from \1", line)
            line = line.replace("  # noqa: E402", "")
        if start or cont:
            cont = line.count("(") > line.count(")") if start else \
                ")" not in line
            line = " ".join(line.split())
        out.append(line)
    return out


def differences(name):
    """(JAX line number, JAX lines, copy lines) of every stretch where the
    normalised scripts differ."""
    a = normalised((JAX / name).read_text())
    b = normalised((PORT / name).read_text())
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return [(i1 + 1, a[i1:i2], b[j1:j2])
            for tag, i1, i2, j1, j2 in ops if tag != "equal"]


def test_every_script_has_a_copy_and_no_other():
    copies = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                    if p.name != "__init__.py")
    assert len(SCRIPTS) == 38
    assert copies == SCRIPTS
    for sub in ("", "MeshRefinement", "UpdatedInterface"):
        assert (PORT / sub / "__init__.py").is_file(), sub


@pytest.mark.parametrize("name", SCRIPTS)
def test_copy_differs_only_in_imports(name):
    lines, why = REMOVED.get(name, ([], None))
    jax = (JAX / name).read_text().splitlines()
    removed = [(n, jax[n - 1]) for n in lines]
    got = []
    for first, old, new in differences(name):
        assert not new, (name, first, old, new)
        got += list(zip(range(first, first + len(old)), old))
    assert [n for n, _ in got] == lines, (name, got, why)
    # every dropped line is one of the sys.path edit's
    for n, text in removed:
        assert re.match(r"(import (sys|os)$|_(here|ex) = |sys\.path\.insert"
                        r"|    os\.path\.abspath)", text), (name, n, text)


def test_normalising_keeps_what_the_copies_changed_visible():
    """The normalisation is no blanket: a changed argument, a changed
    default, or a changed line of code in a copy is a difference."""
    text = (PORT / "BrysonDenham.py").read_text()
    for old, new in (("def run(nsegs=32, print_level=1):",
                      "def run(nsegs=31, print_level=1):"),
                     ("    flag = phase.optimize()",
                      "    flag = phase.solve_optimize()")):
        assert old in text
        a = normalised((JAX / "BrysonDenham.py").read_text())
        b = normalised(text.replace(old, new))
        assert a != b
