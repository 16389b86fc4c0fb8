"""Pure-Python sanity linters for the generated netlists — one rule set per
backend dialect.

These are not parsers — they are tokenizer-level checkers that catch the
classes of emitter bugs that would make the output unsynthesizable:

  * **verilog** — unbalanced ``begin``/``end`` and ``module``/``endmodule``,
    use of undeclared identifiers, duplicate declarations, instances of
    unknown modules;
  * **systemverilog** — the same checks with SV awareness: ``logic``
    declarations, ``always_ff``/``always_comb``, ``typedef enum`` state
    types (the enum labels and the type name become declarations), immediate
    assertions, and the full SV reserved-word table;
  * **vhdl** — ``entity``/``architecture`` pairing, ``process``/``end
    process``, ``if``/``end if``, ``function``/``end function`` balance,
    per-architecture signal/type/port declaration-before-use (VHDL is
    case-insensitive, so the symbol table is too);
  * **circt** — brace/paren balance, per-``hw.module`` SSA def/use closure
    (graph region: order-insensitive), ``hw.instance @Mod`` references must
    resolve.

``lint_backend(text, backend, known_modules=...)`` dispatches on the backend
name; ``lint_verilog`` remains the historical entry point.  ``python -m
repro.core.codegen.lint [--backend NAME|all]`` runs the matching rule set
over every gallery kernel in both inline and hierarchical emission modes —
the CI backend-matrix step.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

from .backends import (SYSTEMVERILOG_KEYWORDS, VERILOG_KEYWORDS,
                       VHDL_KEYWORDS)

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_$]*")
_SIZED_LITERAL = re.compile(r"\d*'s?[bdho][0-9a-fA-FxzXZ_]+")
_MODULE = re.compile(r"^\s*module\s+(?P<name>[A-Za-z_][A-Za-z0-9_]*)")
_INSTANCE = re.compile(
    r"^\s*(?P<mod>[A-Za-z_][A-Za-z0-9_]*)\s+(?P<inst>[A-Za-z_][A-Za-z0-9_]*)\s*\(\s*\.")
_TYPEDEF_ENUM = re.compile(
    r"^\s*typedef\s+enum\b[^{]*\{(?P<labels>[^}]*)\}\s*(?P<tname>\w+)\s*;")


def _decl_re(sv: bool) -> re.Pattern:
    kinds = "input|output|inout|wire|reg"
    if sv:
        kinds += "|logic"
    return re.compile(
        r"^\s*(\(\*.*?\*\)\s*)?(?P<kind>" + kinds + r")\b"
        r"(\s+(wire|logic)\b)?(\s+signed\b)?(\s*\[[^\]]*\])?"
        r"\s*(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    )


def _strip_comments(text: str) -> str:
    text = re.sub(r"\(\*.*?\*\)", " ", text, flags=re.S)  # (* attributes *)
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r'"(?:[^"\\]|\\.)*"', '""', text)  # string literals
    text = re.sub(r"^\s*`\w+[^\n]*$", "", text, flags=re.M)  # `ifdef etc.
    text = re.sub(r"\$[A-Za-z_][A-Za-z0-9_]*", " ", text)  # system tasks
    return text


def _lint_verilog_family(text: str, known_modules: Iterable[str],
                         keywords: frozenset, sv: bool) -> list[str]:
    diags: list[str] = []
    clean = _strip_comments(text)
    lines = clean.split("\n")
    decl = _decl_re(sv)

    # -- balance checks (whole text) ----------------------------------------
    words = re.findall(r"[A-Za-z_][A-Za-z0-9_]*", clean)
    for opener, closer in (("begin", "end"), ("module", "endmodule"),
                           ("case", "endcase")):
        bal = 0
        for w in words:
            if w == opener:
                bal += 1
            elif w == closer:
                bal -= 1
                if bal < 0:
                    diags.append(f"unbalanced {opener}/{closer}: stray {closer}")
                    break
        if bal > 0:
            diags.append(f"unbalanced {opener}/{closer}: {bal} unclosed {opener}")

    # -- per-module declaration / use checks --------------------------------
    defined_modules = {m.group("name") for ln in lines if (m := _MODULE.match(ln))}
    known = set(known_modules) | defined_modules

    declared: set[str] = set()
    user_types: set[str] = set()
    module_name = None
    pending: list[tuple[int, str]] = []  # (lineno, identifier) awaiting decl

    def flush_module(name):
        for lno, ident in pending:
            if ident not in declared:
                diags.append(
                    f"{name or '<top>'}:{lno}: use of undeclared identifier '{ident}'")

    for lno, ln in enumerate(lines, 1):
        m = _MODULE.match(ln)
        if m:
            flush_module(module_name)
            module_name = m.group("name")
            declared = set()
            user_types = set()
            pending = []
            continue
        if re.match(r"^\s*endmodule\b", ln):
            continue

        decl_names: set[str] = set()
        if sv:
            te = _TYPEDEF_ENUM.match(ln)
            if te:
                labels = [l.strip() for l in te.group("labels").split(",")]
                for nm in labels + [te.group("tname")]:
                    if nm:
                        declared.add(nm)
                        decl_names.add(nm)
                user_types.add(te.group("tname"))
            else:
                tv = re.match(r"^\s*(?P<t>[A-Za-z_]\w*)\s+(?P<n>[A-Za-z_]\w*)\s*;",
                              ln)
                if tv and tv.group("t") in user_types:
                    declared.add(tv.group("n"))
                    decl_names.add(tv.group("n"))

        dm = decl.match(ln)
        if dm:
            nm = dm.group("name")
            if nm in declared:
                diags.append(
                    f"{module_name}:{lno}: duplicate declaration of '{nm}'")
            declared.add(nm)
            decl_names.add(nm)

        im = _INSTANCE.match(ln)
        inst_mod = None
        if im and im.group("mod") not in keywords and im.group("mod") not in user_types:
            inst_mod = im.group("mod")
            if inst_mod not in known:
                diags.append(
                    f"{module_name}:{lno}: instance of unknown module '{inst_mod}'")
            declared.add(im.group("inst"))

        # collect identifier uses on the line
        no_lit = _SIZED_LITERAL.sub(" ", ln)
        for ident in _IDENT.findall(no_lit):
            if (ident in keywords or ident.startswith("$")
                    or ident in decl_names or ident in user_types):
                continue
            if inst_mod is not None and ident == inst_mod:
                continue
            if im and ident == im.group("inst"):
                continue
            # port-connection names (.port(...)) belong to the callee
            if im and re.search(rf"\.\s*{re.escape(ident)}\s*\(", ln):
                continue
            if ident in declared:
                continue
            pending.append((lno, ident))

    flush_module(module_name)
    return diags


def lint_verilog(text: str, known_modules: Iterable[str] = ()) -> list[str]:
    """Lint one or more concatenated Verilog modules.  ``known_modules``
    names modules defined elsewhere (blackboxes) that instances may
    reference."""
    return _lint_verilog_family(text, known_modules, VERILOG_KEYWORDS, sv=False)


def lint_systemverilog(text: str,
                       known_modules: Iterable[str] = ()) -> list[str]:
    """Lint concatenated SystemVerilog modules (``logic``, ``always_ff``,
    ``typedef enum`` state types, immediate assertions)."""
    return _lint_verilog_family(text, known_modules,
                                SYSTEMVERILOG_KEYWORDS, sv=True)


# ---------------------------------------------------------------------------
# VHDL
# ---------------------------------------------------------------------------

_VHDL_PORT = re.compile(r"^\s*(?P<name>\w+)\s*:\s*(in|out|inout)\b")
_VHDL_DECL = re.compile(
    r"^\s*(?P<kind>signal|variable|constant|type|attribute)\s+(?P<name>\w+)")
_VHDL_FUNC = re.compile(r"^\s*function\s+(?P<name>\w+)\s*\((?P<params>[^)]*)\)")
_VHDL_LABEL = re.compile(r"^\s*(?P<name>\w+)\s*:\s*(entity|process)\b")
_VHDL_ENTITY = re.compile(r"^\s*entity\s+(?P<name>\w+)\s+is\b")
_VHDL_ARCH = re.compile(
    r"^\s*architecture\s+(?P<name>\w+)\s+of\s+(?P<ent>\w+)\s+is\b")
_VHDL_INST = re.compile(r":\s*entity\s+work\.(?P<mod>\w+)")
_VHDL_IDENT = re.compile(r"[a-z_]\w*")


def lint_vhdl(text: str, known_modules: Iterable[str] = ()) -> list[str]:
    """Lint concatenated VHDL design units: entity/architecture pairing,
    construct balance, per-architecture declaration-before-use (the symbol
    table is case-insensitive, as VHDL is)."""
    diags: list[str] = []
    low = text.lower()
    low = re.sub(r"--[^\n]*", "", low)
    low = re.sub(r'"(?:[^"\\]|\\.)*"', '""', low)
    low = re.sub(r"'.'", " ", low)  # character literals ('0', '1')
    kws = VHDL_KEYWORDS

    def count(rx: str) -> int:
        return len(re.findall(rx, low))

    for opener, orx, crx in (
            ("if", r"\bif\b", r"\bend\s+if\b"),
            ("process", r"\bprocess\b", r"\bend\s+process\b"),
            ("case", r"\bcase\b", r"\bend\s+case\b"),
            ("function", r"\bfunction\s+[a-z_]\w*\s*\(", r"\bend\s+function\b"),
            ("entity", r"\bentity\s+\w+\s+is\b", r"\bend\s+entity\b"),
            ("architecture", r"\barchitecture\s+\w+\s+of\b",
             r"\bend\s+architecture\b"),
    ):
        nc = count(crx)
        no = count(orx) - (nc if opener in ("if", "process", "case") else 0)
        if no != nc:
            diags.append(f"unbalanced {opener}/end {opener}: "
                         f"{no} opener(s), {nc} closer(s)")

    entities = {m.group("name") for ln in low.split("\n")
                if (m := _VHDL_ENTITY.match(ln))}
    known = {k.lower() for k in known_modules} | entities

    ports_of: dict[str, set[str]] = {}
    declared: set[str] = set()
    unit = None          # current diagnostic scope name
    cur_entity = None    # inside an entity port declaration section
    pending: list[tuple[int, str]] = []

    def flush(name):
        for lno, ident in pending:
            if ident not in declared:
                diags.append(
                    f"{name or '<top>'}:{lno}: use of undeclared identifier "
                    f"'{ident}'")

    for lno, ln in enumerate(low.split("\n"), 1):
        em = _VHDL_ENTITY.match(ln)
        if em:
            flush(unit)
            pending = []
            cur_entity = em.group("name")
            unit = f"entity {cur_entity}"
            ports_of.setdefault(cur_entity, set())
            declared = {cur_entity} | kws
            continue
        am = _VHDL_ARCH.match(ln)
        if am:
            flush(unit)
            pending = []
            ent = am.group("ent")
            unit = f"architecture {am.group('name')} of {ent}"
            if ent not in known:
                diags.append(
                    f"{lno}: architecture of unknown entity '{ent}'")
            cur_entity = None
            declared = ({am.group("name"), ent}
                        | ports_of.get(ent, set()) | kws)
            continue
        if re.match(r"^\s*end\b", ln):
            continue

        decl_names: set[str] = set()
        if cur_entity is not None:
            pm = _VHDL_PORT.match(ln)
            if pm:
                ports_of[cur_entity].add(pm.group("name"))
                declared.add(pm.group("name"))
                decl_names.add(pm.group("name"))
        dm = _VHDL_DECL.match(ln)
        if dm:
            nm = dm.group("name")
            if dm.group("kind") != "attribute" and nm in declared and nm not in kws:
                diags.append(f"{unit}:{lno}: duplicate declaration of '{nm}'")
            declared.add(nm)
            decl_names.add(nm)
        fm = _VHDL_FUNC.match(ln)
        if fm:
            declared.add(fm.group("name"))
            decl_names.add(fm.group("name"))
            for param in fm.group("params").split(";"):
                pname = param.split(":")[0].strip()
                if pname:
                    declared.add(pname)
                    decl_names.add(pname)
        lm = _VHDL_LABEL.match(ln)
        if lm:
            declared.add(lm.group("name"))
            decl_names.add(lm.group("name"))
        inst = _VHDL_INST.search(ln)
        if inst and inst.group("mod") not in known:
            diags.append(
                f"{unit}:{lno}: instantiation of unknown entity "
                f"'{inst.group('mod')}'")

        # formals in a one-line "port map (a => b, ...)" belong to the
        # callee, as does the "work.<entity>" selected name itself
        use_ln = re.sub(r"\bwork\.\w+", " ", ln)
        if "port map" in ln:
            use_ln = re.sub(r"(\w+)\s*=>", "=>", use_ln)
        for ident in _VHDL_IDENT.findall(use_ln):
            if ident in kws or ident in declared or ident in decl_names:
                continue
            pending.append((lno, ident))

    flush(unit)
    return diags


# ---------------------------------------------------------------------------
# CIRCT (hw/comb/seq textual MLIR)
# ---------------------------------------------------------------------------

_MLIR_MODULE = re.compile(r"^\s*hw\.module\s+@(?P<name>[\w$.]+)")
_MLIR_SSA = re.compile(r"%[\w$.-]+")
_MLIR_SYM = re.compile(r"@([\w$.]+)")


def lint_circt(text: str, known_modules: Iterable[str] = ()) -> list[str]:
    """Lint hw/comb/seq-dialect textual MLIR: brace/paren balance and, per
    ``hw.module`` (a graph region, so definition order is irrelevant), SSA
    def/use closure plus ``hw.instance`` symbol resolution."""
    diags: list[str] = []
    clean = re.sub(r'"(?:[^"\\]|\\.)*"', '""', text)
    clean = re.sub(r"//[^\n]*", "", clean)
    for o, c in (("{", "}"), ("(", ")"), ("[", "]")):
        if clean.count(o) != clean.count(c):
            diags.append(f"unbalanced {o}{c}: {clean.count(o)} opener(s), "
                         f"{clean.count(c)} closer(s)")

    lines = clean.split("\n")
    defined = {m.group("name") for ln in lines if (m := _MLIR_MODULE.match(ln))}
    known = set(known_modules) | defined

    module = None
    defs: set[str] = set()
    uses: list[tuple[int, str]] = []

    def flush(name):
        for lno, ssa in uses:
            if ssa not in defs:
                diags.append(f"{name or '<top>'}:{lno}: use of undefined "
                             f"SSA value '{ssa}'")

    for lno, ln in enumerate(lines, 1):
        mm = _MLIR_MODULE.match(ln)
        if mm:
            flush(module)
            module = mm.group("name")
            defs = set()
            uses = []
            for arg in re.findall(r"in\s+(%[\w$.-]+)\s*:", ln):
                defs.add(arg)
            continue
        if ln.strip() == "}":
            continue
        if "=" in ln:
            # results left of the first '=' are definitions (this also
            # matches `seq.firmem.write_port %mem[...] = ...`, where the
            # memory symbol is a re-reference — a harmless re-definition)
            lhs, rhs = ln.split("=", 1)
            for d in _MLIR_SSA.findall(lhs):
                defs.add(d)
        else:
            rhs = ln
        for u in _MLIR_SSA.findall(rhs):
            uses.append((lno, u))
        if "hw.instance" in ln:
            for sym in _MLIR_SYM.findall(ln):
                if sym not in known:
                    diags.append(f"{module}:{lno}: instance of unknown "
                                 f"module '@{sym}'")
    flush(module)
    return diags


# ---------------------------------------------------------------------------
# Dispatch + CLI
# ---------------------------------------------------------------------------

DIALECT_LINTERS = {
    "verilog": lint_verilog,
    "systemverilog": lint_systemverilog,
    "vhdl": lint_vhdl,
    "circt": lint_circt,
}


def lint_backend(text: str, backend: str,
                 known_modules: Iterable[str] = ()) -> list[str]:
    """Run the rule set matching ``backend`` over ``text``."""
    try:
        linter = DIALECT_LINTERS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(DIALECT_LINTERS)}") from None
    return linter(text, known_modules=known_modules)


def _iter_gallery_rtl(backend: str = "verilog"
                      ) -> Iterable[tuple[str, str, str, Sequence[str]]]:
    """(kernel, mode, concatenated text, module names) for every gallery
    kernel in both emission modes, emitted by ``backend``."""
    from ..gallery import GALLERY
    from ..passes import DEFAULT_PIPELINE_SPEC, PassManager
    from .verilog import generate_verilog

    for name, gal in sorted(GALLERY.items()):
        module, entry = gal.build()
        PassManager.from_spec(DEFAULT_PIPELINE_SPEC).run(module)
        for mode in ("inline", "modules"):
            mods = generate_verilog(module.clone(), entry, hierarchy=mode,
                                    backend=backend)
            text = "\n".join(vm.text for vm in mods.values())
            yield name, mode, text, list(mods)


def main(backends: Iterable[str] = ("verilog",)) -> int:
    failures = 0
    for backend in backends:
        for name, mode, text, modnames in _iter_gallery_rtl(backend):
            diags = lint_backend(text, backend, known_modules=modnames)
            status = "ok" if not diags else f"{len(diags)} issue(s)"
            print(f"lint[{backend:13s}] {name:12s} [{mode:7s}] {status}")
            for d in diags:
                print(f"  {d}")
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="lint the generated netlists of every gallery kernel")
    ap.add_argument("--backend", default="verilog",
                    help="backend dialect to emit+lint, or 'all' "
                         f"({sorted(DIALECT_LINTERS)})")
    args = ap.parse_args()
    names = (sorted(DIALECT_LINTERS) if args.backend == "all"
             else [args.backend])
    raise SystemExit(main(names))
