"""AST passes: lock discipline, clock-seam purity, banned APIs.

Port of ``repro/analysis/ast_passes.py``, rule for rule: the same three
passes give the same findings on the same text in both packages.

All three run on parsed source only -- no imports of the analyzed
modules, so a fixture file full of deliberate violations is safe to
check in (tests/analysis_fixtures/) and the passes run in milliseconds
over the whole of ``src/repro_torch``.

Lock discipline is declaration-driven: a class opts in by declaring

    _SLINGLINT_GUARDED = {"locks": ("_lock",), "fields": ("_queues",)}

after which every mutation of a guarded ``self.<field>`` must happen
(a) inside ``with self.<lock>:``, (b) in a method whose name ends in
``_locked`` (the repo convention: such helpers run under the lock --
see serve/frontend.py), or (c) in ``__init__`` (pre-publication).
Symmetrically, no blocking call may run *while* a declared lock is
held -- ``Condition.wait``/``wait_for`` on a declared lock excepted
(they release it). Manual ``self.<lock>.acquire()``/``release()``
pairs are tracked in lexical statement order, which is exactly the
shape of ``MonotonicClock._run``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Context, Finding, Pass, SourceFile

GUARDED_DECL = "_SLINGLINT_GUARDED"

# container methods that mutate their receiver in place
_MUTATORS = {"append", "appendleft", "extend", "insert", "add",
             "remove", "discard", "pop", "popleft", "popitem",
             "clear", "update", "setdefault", "sort", "reverse",
             "move_to_end"}
# heapq free functions that mutate their first argument
_HEAP_MUTATORS = {"heappush", "heappop", "heappushpop", "heapreplace",
                  "heapify"}
# attribute calls that block the calling thread regardless of receiver
_BLOCKING_ATTRS = {"sleep", "join", "result", "block_until_ready"}
# blocking unless the receiver is a declared lock (Condition.wait
# releases the lock it waits on)
_WAIT_ATTRS = {"wait", "wait_for"}
# self-methods that must never run under the frontend lock (dispatch
# runs engine work / joins queues; the repo invariant is
# "close under the lock, dispatch outside it")
_BLOCKING_SELF = {"_dispatch", "_run_unit", "flush", "drain"}


def _self_attr_root(node) -> str | None:
    """``self._counts["x"]`` / ``self._epoch`` -> the attribute name
    rooted at ``self``, else None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def _is_self_lock(node, locks) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self" and node.attr in locks)


class _MethodChecker:
    """Walks one method's statements with a lexical held-lock depth."""

    def __init__(self, sf: SourceFile, cls: ast.ClassDef,
                 fn: ast.FunctionDef, locks, fields,
                 findings: list[Finding]):
        self.sf, self.cls, self.fn = sf, cls, fn
        self.locks, self.fields = locks, fields
        self.findings = findings
        self.held = 1 if fn.name.endswith("_locked") else 0

    def _emit(self, node, what: str, message: str) -> None:
        self.findings.append(Finding(
            pass_id=LockDisciplinePass.pass_id, file=self.sf.path,
            line=node.lineno,
            key=f"{self.cls.name}.{self.fn.name}:{what}",
            message=message))

    # -- statement walk ------------------------------------------------
    def check(self) -> None:
        self._stmts(self.fn.body)

    def _stmts(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt) -> None:
        if isinstance(stmt, ast.With):
            lock_items = sum(
                1 for item in stmt.items
                if _is_self_lock(item.context_expr, self.locks))
            for item in stmt.items:
                self._exprs(item.context_expr)
            self.held += lock_items
            self._stmts(stmt.body)
            self.held -= lock_items
        elif isinstance(stmt, (ast.If, ast.While)):
            self._exprs(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._exprs(stmt.iter)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass  # nested defs run later, under unknown lock state
        else:
            if self._acquire_release(stmt):
                return
            self._simple(stmt)

    def _acquire_release(self, stmt) -> bool:
        """Lexical ``self.<lock>.acquire()`` / ``.release()`` stmt."""
        if not (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)):
            return False
        func = stmt.value.func
        if not _is_self_lock(func.value, self.locks):
            return False
        if func.attr == "acquire":
            self.held += 1
            return True
        if func.attr == "release":
            self.held = max(0, self.held - 1)
            return True
        return False

    # -- expression scan -----------------------------------------------
    def _simple(self, stmt) -> None:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = stmt.targets
        for t in targets:
            root = _self_attr_root(t)
            if root in self.fields and not self._mutation_ok():
                self._emit(
                    t, root,
                    f"guarded field 'self.{root}' assigned outside "
                    f"'with self.{'/'.join(self.locks)}' in "
                    f"{self.cls.name}.{self.fn.name} "
                    f"(declared in {GUARDED_DECL})")
        self._exprs(stmt)

    def _mutation_ok(self) -> bool:
        return self.held > 0

    def _exprs(self, node) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub)

    def _call(self, call: ast.Call) -> None:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        # in-place mutation of a guarded container
        if func.attr in _MUTATORS:
            root = _self_attr_root(func.value)
            if root in self.fields and not self._mutation_ok():
                self._emit(
                    call, root,
                    f"guarded field 'self.{root}' mutated "
                    f"(.{func.attr}) outside the declared lock in "
                    f"{self.cls.name}.{self.fn.name}")
        if func.attr in _HEAP_MUTATORS and call.args:
            root = _self_attr_root(call.args[0])
            if root in self.fields and not self._mutation_ok():
                self._emit(
                    call, root,
                    f"guarded field 'self.{root}' mutated "
                    f"(heapq.{func.attr}) outside the declared lock "
                    f"in {self.cls.name}.{self.fn.name}")
        # blocking call while holding the lock
        if self.held > 0:
            blocking = func.attr in _BLOCKING_ATTRS
            if func.attr in _WAIT_ATTRS \
                    and not _is_self_lock(func.value, self.locks):
                blocking = True
            if func.attr in _BLOCKING_SELF \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id == "self":
                blocking = True
            if blocking:
                self._emit(
                    call, f"blocking:{func.attr}",
                    f"blocking call '.{func.attr}(...)' while holding "
                    f"a declared lock in "
                    f"{self.cls.name}.{self.fn.name} (close under "
                    f"the lock, dispatch/block outside it)")


class LockDisciplinePass(Pass):
    """Guarded-by checker for classes declaring _SLINGLINT_GUARDED."""

    pass_id = "lock-discipline"

    def run(self, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        for sf in ctx.files:
            for node in ast.walk(sf.tree()):
                if isinstance(node, ast.ClassDef):
                    self._check_class(sf, node, findings)
        return findings

    def check_source(self, path: str, text: str) -> list[Finding]:
        """Run on one (path, text) pair -- the hook tests use to prove
        a deleted ``with self._lock:`` is caught statically."""
        ctx = Context(files=[SourceFile(path=path, text=text)],
                      root=None)
        return self.run(ctx)

    def _check_class(self, sf, cls: ast.ClassDef,
                     findings: list[Finding]) -> None:
        decl = None
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == GUARDED_DECL
                            for t in stmt.targets):
                decl = stmt
        if decl is None:
            return
        try:
            spec = ast.literal_eval(decl.value)
            locks = tuple(spec["locks"])
            fields = tuple(spec["fields"])
            assert locks and all(isinstance(x, str) for x in locks)
            assert all(isinstance(x, str) for x in fields)
        except Exception:
            findings.append(Finding(
                pass_id=self.pass_id, file=sf.path, line=decl.lineno,
                key=f"{cls.name}:decl",
                message=f"{GUARDED_DECL} must be a literal dict with "
                        "'locks' and 'fields' tuples of attribute "
                        "names"))
            return
        for stmt in cls.body:
            if isinstance(stmt, ast.FunctionDef) \
                    and stmt.name != "__init__":
                _MethodChecker(sf, cls, stmt, locks, fields,
                               findings).check()


# ----------------------------------------------------------------------
# clock-seam purity
# ----------------------------------------------------------------------
def _scope_map(tree: ast.Module) -> dict:
    """node -> dotted def/class path (stable finding keys)."""
    out: dict = {}

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            s = scope
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                s = f"{scope}.{child.name}" if scope else child.name
            out[child] = s
            visit(child, s)
    visit(tree, "")
    return out


def _import_aliases(tree: ast.Module, module: str):
    """-> (module aliases, {local name: imported name}) for ``module``."""
    mod_aliases: set = set()
    direct: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                direct[a.asname or a.name] = a.name
    return mod_aliases, direct


class ClockSeamPass(Pass):
    """No wall-clock reads or sleeps outside the serve/clock.py seam.

    Generalizes the old ``inspect.getsource`` grep in
    tests/test_frontend.py: every "what time is it" must go through an
    injectable clock object (DESIGN.md section 12), so the virtual-
    clock test harness stays bit-deterministic. ``time.perf_counter``
    (duration metrics, never scheduling) stays allowed; inside
    serve/clock.py itself only ``time.sleep`` is banned -- the
    MonotonicClock waits on a Condition, never sleeps.
    """

    pass_id = "clock-seam"
    BANNED = ("sleep", "monotonic", "time")
    SEAM = "serve/clock.py"

    def run(self, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        for sf in ctx.files:
            findings.extend(self.check_file(sf))
        return findings

    def check_file(self, sf: SourceFile) -> list[Finding]:
        tree = sf.tree()
        banned = ({"sleep"} if sf.path.endswith(self.SEAM)
                  else set(self.BANNED))
        mod_aliases, direct = _import_aliases(tree, "time")
        scopes = _scope_map(tree)
        findings: list[Finding] = []

        def emit(node, name):
            scope = scopes.get(node, "") or "<module>"
            findings.append(Finding(
                pass_id=self.pass_id, file=sf.path, line=node.lineno,
                key=f"time.{name}:{scope}",
                message=f"'time.{name}' outside the {self.SEAM} seam "
                        f"(in {scope}): route timing through the "
                        "injectable clock (DESIGN.md section 12)"))

        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in mod_aliases \
                    and node.attr in banned:
                emit(node, node.attr)
            elif isinstance(node, ast.Name) \
                    and direct.get(node.id) in banned \
                    and isinstance(node.ctx, ast.Load):
                emit(node, direct[node.id])
        return findings


# ----------------------------------------------------------------------
# banned APIs
# ----------------------------------------------------------------------
class BannedApiPass(Pass):
    """Deprecated / unsafe APIs with in-repo replacements.

    * ``jax.ops.segment_sum`` -- removed upstream; the port's segment
      sum is ``repro_torch.models.layers.segment_sum``. The rule stays
      as the reference writes it, so both packages flag the same text.
    * raw ``np.savez`` / ``np.savez_compressed`` / ``np.save`` --
      artifact writes go through the atomic tmp + fsync + ``os.replace``
      writers (INDEX_FORMAT.md); a raw savez at a durable path risks a
      torn artifact on preemption. Scratch/tmp-dir uses carry an
      inline-justified suppression.
    * ``os.rename`` -- not atomic-overwrite across platforms; use
      ``os.replace``.
    """

    pass_id = "banned-api"
    NP_BANNED = ("savez", "savez_compressed", "save")

    def run(self, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        for sf in ctx.files:
            findings.extend(self.check_file(sf))
        return findings

    def check_file(self, sf: SourceFile) -> list[Finding]:
        tree = sf.tree()
        np_mod, np_direct = _import_aliases(tree, "numpy")
        os_mod, os_direct = _import_aliases(tree, "os")
        jax_mod, jax_direct = _import_aliases(tree, "jax")
        scopes = _scope_map(tree)
        findings: list[Finding] = []

        def emit(node, api, fix):
            scope = scopes.get(node, "") or "<module>"
            findings.append(Finding(
                pass_id=self.pass_id, file=sf.path, line=node.lineno,
                key=f"{api}:{scope}",
                message=f"banned API '{api}' (in {scope}): {fix}"))

        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            if isinstance(base, ast.Name):
                if base.id in np_mod and node.attr in self.NP_BANNED:
                    emit(node, f"np.{node.attr}",
                         "write via the atomic tmp+fsync+os.replace "
                         "artifact writers (INDEX_FORMAT.md)")
                elif base.id in os_mod and node.attr == "rename":
                    emit(node, "os.rename",
                         "use os.replace (atomic overwrite)")
            # jax.ops.segment_sum (and `from jax import ops`)
            if node.attr == "segment_sum" \
                    and isinstance(base, ast.Attribute) \
                    and base.attr == "ops" \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in jax_mod:
                emit(node, "jax.ops.segment_sum",
                     "use repro_torch.models.layers.segment_sum")
            elif node.attr == "segment_sum" \
                    and isinstance(base, ast.Name) \
                    and jax_direct.get(base.id) == "ops":
                emit(node, "jax.ops.segment_sum",
                     "use repro_torch.models.layers.segment_sum")
        # from numpy import savez / from os import rename
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load):
                if np_direct.get(node.id) in self.NP_BANNED:
                    emit(node, f"np.{np_direct[node.id]}",
                         "write via the atomic tmp+fsync+os.replace "
                         "artifact writers (INDEX_FORMAT.md)")
                elif os_direct.get(node.id) == "rename":
                    emit(node, "os.rename",
                         "use os.replace (atomic overwrite)")
        return findings
