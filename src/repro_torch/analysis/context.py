"""Per-file analysis context and the whole-package call-graph index.

``FileContext`` owns everything a rule needs about one Python module: the
parsed tree, a parent map, import-alias resolution (``np.asarray`` →
``numpy.asarray``), and which functions run captured or compiled and how
(a ``torch.compile`` decorator or wrapper,
``torch.cuda.make_graphed_callables``, a call inside a ``with
torch.cuda.graph(...)`` block).

``CudaContext`` is the same for a ``.cu`` source: the code with comments
blanked, the file's ``constexpr`` integers, each ``__global__`` kernel with
its template parameters, ``__launch_bounds__`` and static ``__shared__``
declarations, the launch sites, and the instantiations the launch switches
name (propagated from the non-template functions through every template
call, with a small evaluator of C++ integer expressions).

``ProjectIndex`` is the cross-module layer: it records, for every function
in the analyzed set, whether its body (transitively, through a dotted-name
call graph) reads the runtime config. That is what lets the RC rules flag a
captured function whose *callee* resolves ``runtime.active()`` while it is
being captured, and not just bodies that mention ``active()`` lexically.

Everything here is stdlib-only (ast, tokenize, re): the analyzer imports
neither torch nor the package it reads.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

# dotted names whose *call* reads the active runtime config. The attribute
# form through any alias of repro_torch.runtime / repro_torch.runtime.config
# resolves onto one of these.
CONFIG_READ_CALLS = frozenset({
    "repro_torch.runtime.active",
    "repro_torch.runtime.dispatch_key",
    "repro_torch.runtime.default_config",
    "repro_torch.runtime.config_from_env",
    "repro_torch.runtime.config.active",
    "repro_torch.runtime.config.dispatch_key",
    "repro_torch.runtime.config.default_config",
    "repro_torch.runtime.config.config_from_env",
})

#: calls that compile or capture the callable they are handed (arg 0)
CAPTURE_CALLS = frozenset({"torch.compile", "torch.cuda.make_graphed_callables"})
#: context managers whose block runs under CUDA-graph capture
GRAPH_BLOCKS = frozenset({"torch.cuda.graph"})
#: constructors of a graph or a compiled wrapper (RT303)
BUILD_CALLS = frozenset({"torch.compile", "torch.cuda.CUDAGraph",
                         "torch.cuda.make_graphed_callables"})

#: the cache-key pin: a captured or compiled function carrying this
#: parameter declares its config reads covered by the runtime's
#: ``dispatch_key()``, which its caller re-captures or recompiles on.
DISPATCH_PARAM = "_dispatch"


def module_name_for_path(path: str) -> str:
    """Repo-relative path -> dotted module name (``src/`` layout aware)."""
    p = path.replace("\\", "/")
    for prefix in ("src/",):
        if p.startswith(prefix):
            p = p[len(prefix):]
    if p.endswith(".py"):
        p = p[:-3]
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


@dataclasses.dataclass
class FuncInfo:
    """One function (or lambda) and what the analyzer knows about it."""

    node: ast.AST                 # FunctionDef / AsyncFunctionDef / Lambda
    qualname: str                 # module.Class.name / module.name / <lambda>
    path: str
    captured: bool = False
    capture_reason: str = ""      # "decorator" | "torch.compile(...)" | "graph"
    has_dispatch: bool = False
    calls: Set[str] = dataclasses.field(default_factory=set)
    reads_config: bool = False    # lexical read in this body
    config_read_lines: List[int] = dataclasses.field(default_factory=list)


def _arg_names(node: ast.AST) -> List[str]:
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


class FileContext:
    """Parsed module + resolution helpers, shared by every rule."""

    def __init__(self, path: str, source: str,
                 project: Optional["ProjectIndex"] = None):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.module = module_name_for_path(self.path)
        self.tree = ast.parse(source)
        self.project = project

        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

        self.aliases = self._collect_aliases()
        self.functions: Dict[ast.AST, FuncInfo] = {}
        self._collect_functions()
        self._detect_capture()

    # ------------------------------------------------------------ imports
    def _collect_aliases(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: resolve against this package
                    base_parts = self.module.split(".")
                    # level 1 = current package (drop the module segment)
                    base_parts = base_parts[: len(base_parts) - node.level]
                    base = ".".join(base_parts)
                else:
                    base = ""
                mod = ".".join(x for x in (base, node.module or "") if x)
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = (
                        f"{mod}.{a.name}" if mod else a.name)
        return aliases

    # ---------------------------------------------------------- functions
    def _collect_functions(self) -> None:
        def visit(node: ast.AST, scope: List[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join([self.module] + scope + [child.name])
                    self._add_function(child, qual)
                    visit(child, scope + [child.name])
                elif isinstance(child, ast.ClassDef):
                    visit(child, scope + [child.name])
                elif isinstance(child, ast.Lambda):
                    qual = ".".join([self.module] + scope + ["<lambda>"])
                    self._add_function(child, qual)
                    visit(child, scope)
                else:
                    visit(child, scope)

        visit(self.tree, [])

    def _add_function(self, node: ast.AST, qual: str) -> None:
        info = FuncInfo(node=node, qualname=qual, path=self.path,
                        has_dispatch=DISPATCH_PARAM in _arg_names(node))
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = self.dotted(sub.func)
                if name:
                    info.calls.add(name)
                    if name in CONFIG_READ_CALLS:
                        info.reads_config = True
                        info.config_read_lines.append(sub.lineno)
        self.functions[node] = info

    # -------------------------------------------------------- capture map
    def _detect_capture(self) -> None:
        # 1. decorators: @torch.compile / @torch.compile(...)
        for node, info in self.functions.items():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if self.dotted(target) in CAPTURE_CALLS:
                    info.captured = True
                    info.capture_reason = "decorator"
        # 2. call sites: torch.compile(<lambda> | <local name>), and the
        # functions called by name inside a `with torch.cuda.graph(...)`
        by_name = {
            info.qualname.rsplit(".", 1)[-1]: info
            for node, info in self.functions.items()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self.dotted(node.func) in CAPTURE_CALLS:
                for arg in node.args[:1]:  # the captured callable is arg 0
                    target: Optional[ast.AST] = None
                    if isinstance(arg, ast.Lambda):
                        target = arg
                    elif isinstance(arg, ast.Name) and arg.id in by_name:
                        target = by_name[arg.id].node
                    if target is not None and target in self.functions:
                        info = self.functions[target]
                        info.captured = True
                        info.capture_reason = f"{self.dotted(node.func)}(...)"
            elif self._graph_block(node):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                            and sub.func.id in by_name:
                        info = by_name[sub.func.id]
                        info.captured = True
                        info.capture_reason = "graph"

    def _graph_block(self, node: ast.AST) -> bool:
        """Whether ``node`` is a ``with torch.cuda.graph(...)`` block."""
        return isinstance(node, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Call)
            and self.dotted(item.context_expr.func) in GRAPH_BLOCKS
            for item in node.items)

    # --------------------------------------------------------- resolution
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Best-effort dotted name for a Name/Attribute chain.

        ``np.asarray`` -> ``numpy.asarray``; ``runtime.active`` ->
        ``repro_torch.runtime.active``; a bare name naming a module-level def ->
        its qualified name; ``self.f`` -> ``module.Class.f`` when the
        chain starts at ``self`` inside a class. Returns None for
        anything dynamic.
        """
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(cur.id)
        parts.reverse()
        head, rest = parts[0], parts[1:]
        if head == "self" and rest:
            cls = self._enclosing_class(node)
            if cls is not None:
                return ".".join([self.module, cls.name] + rest)
            return None
        base = self.aliases.get(head)
        if base is None:
            # a bare local name: qualify module-level defs so the call
            # graph can link them
            if not rest and any(
                info.qualname == f"{self.module}.{head}"
                for info in self.functions.values()
            ):
                return f"{self.module}.{head}"
            base = head if rest else None
            if base is None:
                return None
        return ".".join([base] + rest)

    def _enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_functions(self, node: ast.AST) -> Iterator[FuncInfo]:
        """Innermost-out FuncInfo chain containing ``node``."""
        cur = self.parents.get(node)
        while cur is not None:
            if cur in self.functions:
                yield self.functions[cur]
            cur = self.parents.get(cur)

    def enclosing_capture(self, node: ast.AST) -> Optional[FuncInfo]:
        """Nearest enclosing function that runs captured or compiled, or a
        stand-in for the ``with torch.cuda.graph(...)`` block ``node``
        sits in.

        Anything lexically inside a captured function — including nested
        helper defs, which execute when the capture calls them — counts.
        This over-approximates (a nested def that is only ever returned,
        not called, still counts) and rules accept that: the pragma
        mechanism exists for the rare justified case.
        """
        for info in self.enclosing_functions(node):
            if info.captured:
                return info
        cur = self.parents.get(node)
        while cur is not None:
            if self._graph_block(cur):
                return FuncInfo(node=cur, qualname=f"{self.module}.<graph block>",
                                path=self.path, captured=True,
                                capture_reason="graph")
            cur = self.parents.get(cur)
        return None

    def in_loop(self, node: ast.AST) -> bool:
        """Whether ``node`` sits lexically inside a for/while body of the
        same function (crossing a def boundary resets — a closure defined
        in a loop is the closure's problem, not its body's)."""
        cur = self.parents.get(node)
        child = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                # the For iterable evaluates once, everything else in the
                # loop node (body / orelse / While test) runs per iteration
                if not (isinstance(cur, (ast.For, ast.AsyncFor))
                        and child is cur.iter):
                    return True
            child = cur
            cur = self.parents.get(cur)
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class ProjectIndex:
    """Cross-module view: which functions read the config, transitively.

    Built from every analyzed file's ``FuncInfo`` records, then closed
    over the dotted-name call graph to a fixed point. Resolution is
    best-effort by construction — a call the graph cannot link (dynamic
    dispatch, registries) simply does not propagate, which keeps the
    analysis quiet rather than noisy; the self-test pins the idioms it
    must catch.
    """

    def __init__(self) -> None:
        self.functions: Dict[str, FuncInfo] = {}

    def add_file(self, ctx: FileContext) -> None:
        for info in ctx.functions.values():
            if info.qualname.endswith("<lambda>"):
                continue  # lambdas are analyzed via their enclosing function
            # first definition wins; duplicate qualnames (overloads in
            # branches) are rare enough to ignore
            self.functions.setdefault(info.qualname, info)

    def finalize(self) -> None:
        """Fixed-point propagation of ``reads_config`` up the call graph."""
        changed = True
        while changed:
            changed = False
            for info in self.functions.values():
                if info.reads_config:
                    continue
                for callee in info.calls:
                    target = self.functions.get(callee)
                    if target is not None and target.reads_config:
                        info.reads_config = True
                        changed = True
                        break

    def reads_config(self, qualname: str) -> bool:
        info = self.functions.get(qualname)
        return bool(info and info.reads_config)

    def reading_callees(self, info: FuncInfo) -> List[str]:
        """Which of ``info``'s direct callees (transitively) read config."""
        out = []
        for callee in sorted(info.calls):
            target = self.functions.get(callee)
            if target is not None and target.reads_config:
                out.append(callee)
        return out


# ------------------------------------------------------------------ CUDA
TYPE_BYTES = {
    "char": 1, "signed char": 1, "unsigned char": 1, "bool": 1, "int8_t": 1,
    "uint8_t": 1, "short": 2, "__half": 2, "half": 2, "__nv_bfloat16": 2,
    "int": 4, "unsigned": 4, "unsigned int": 4, "float": 4, "int32_t": 4,
    "uint32_t": 4, "long long": 8, "unsigned long long": 8, "double": 8,
    "size_t": 8, "int64_t": 8, "float2": 8, "int2": 8, "float4": 16, "int4": 16,
    "double2": 16,
}
#: float element types (the float-atomics rule)
FLOAT_TYPES = frozenset({"float", "double", "__half", "half", "__nv_bfloat16",
                         "float2", "float4", "double2", "__half2",
                         "__nv_bfloat162"})

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+(?:static\s+)?(int|size_t|unsigned|long long|float)\s+"
    r"(\w+)\s*=\s*([^;]+);")
_TEMPLATE_RE = re.compile(r"\btemplate\s*<")
_SHARED_RE = re.compile(r"(\bextern\s+)?__shared__\s+(?:__align__\((\d+)\)\s+)?"
                        r"((?:unsigned |signed |long )*\w+)\s+([^;]+);")
_LAUNCH_RE = re.compile(r"\b(\w+)\s*(<[^;{}]*?>)?\s*<<<")


def _blank_comments(src: str) -> str:
    """``src`` with every comment turned into spaces (lines kept)."""
    return _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), src)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        c = text[j]
        if c == open_:
            depth += 1
        elif c == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def split_top(text: str, sep: str = ",") -> List[str]:
    """``text`` split at ``sep`` outside (), <>, [] and {}."""
    out, depth, cur = [], 0, ""
    for c in text:
        if c in "(<[{":
            depth += 1
        elif c in ")>]}":
            depth -= 1
        if c == sep and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += c
    if cur.strip():
        out.append(cur.strip())
    return out


_TOKEN_RE = re.compile(r"\s*(?:(\d+(?:\.\d*)?(?:[eE][-+]?\d+)?)[uUlLfF]*|"
                       r"(\w+)|(<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%()<>?:!~&|^]))")


class CExprError(ValueError):
    pass


def eval_c(expr: str, env: Dict[str, int]):
    """The value of a C++ integer (or float) expression of literals, names
    bound in ``env``, ``sizeof(type)`` and the arithmetic, comparison,
    logical and ternary operators; raise :class:`CExprError` otherwise."""
    expr = re.sub(r"\bsizeof\s*\(\s*([\w ]+?)\s*\)",
                  lambda m: str(_sizeof(m.group(1), env)), expr)
    expr = re.sub(r"\((?:size_t|int|unsigned|long long|float)\)", "", expr)
    toks: List[Tuple[str, str]] = []
    pos = 0
    expr = expr.strip()
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if not m or m.end() == pos:
            raise CExprError(f"cannot read {expr[pos:]!r}")
        pos = m.end()
        if m.group(1):
            toks.append(("num", m.group(1)))
        elif m.group(2):
            toks.append(("name", m.group(2)))
        else:
            toks.append(("op", m.group(3)))
    p = _CParser(toks, env)
    v = p.ternary()
    if p.i != len(toks):
        raise CExprError(f"trailing tokens in {expr!r}")
    return v


def _sizeof(t: str, env: Dict[str, int]) -> int:
    t = " ".join(t.split())
    t = str(env.get(t, t))
    if t not in TYPE_BYTES:
        raise CExprError(f"sizeof({t})")
    return TYPE_BYTES[t]


_BINARY = [("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
           ("<", "<=", ">", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%")]


class _CParser:
    def __init__(self, toks, env):
        self.toks, self.env, self.i = toks, env, 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("end", "")

    def take(self, want=None):
        t = self.peek()
        if want is not None and t[1] != want:
            raise CExprError(f"want {want!r}, got {t[1]!r}")
        self.i += 1
        return t

    def ternary(self):
        c = self.binary(0)
        if self.peek()[1] == "?":
            self.take("?")
            a = self.ternary()
            self.take(":")
            b = self.ternary()
            return a if c else b
        return c

    def binary(self, level):
        if level == len(_BINARY):
            return self.unary()
        v = self.binary(level + 1)
        while self.peek()[0] == "op" and self.peek()[1] in _BINARY[level]:
            op = self.take()[1]
            w = self.binary(level + 1)
            v = _apply(op, v, w)
        return v

    def unary(self):
        t = self.peek()
        if t[1] in ("-", "+", "!", "~"):
            self.take()
            v = self.unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~int(v)}[t[1]]
        if t[1] == "(":
            self.take("(")
            v = self.ternary()
            self.take(")")
            return v
        if t[0] == "num":
            self.take()
            return float(t[1]) if any(c in t[1] for c in ".eE") else int(t[1])
        if t[0] == "name":
            self.take()
            if t[1] in ("true", "false"):
                return int(t[1] == "true")
            if t[1] in self.env and isinstance(self.env[t[1]], (int, float)):
                return self.env[t[1]]
            raise CExprError(f"unknown name {t[1]!r}")
        raise CExprError(f"unexpected {t[1]!r}")


def _apply(op, a, b):
    if op == "/":
        if b == 0:
            raise CExprError("division by zero")
        return a // b if isinstance(a, int) and isinstance(b, int) else a / b
    if op == "%":
        if b == 0:
            raise CExprError("division by zero")
        return a % b
    return {"+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
            "<<": lambda: a << b, ">>": lambda: a >> b, "&": lambda: a & b,
            "|": lambda: a | b, "^": lambda: a ^ b, "<": lambda: int(a < b),
            "<=": lambda: int(a <= b), ">": lambda: int(a > b),
            ">=": lambda: int(a >= b), "==": lambda: int(a == b),
            "!=": lambda: int(a != b), "&&": lambda: int(bool(a and b)),
            "||": lambda: int(bool(a or b))}[op]()


@dataclasses.dataclass
class CudaFunction:
    """One function definition of a ``.cu`` source."""

    name: str
    line: int
    params: List[Tuple[str, str]]     # template parameters: (kind, name)
    body: str                          # the body, comments blanked
    body_start: int                    # offset of the body in the code
    is_kernel: bool = False
    launch_bounds: Optional[str] = None  # the first __launch_bounds__ argument


@dataclasses.dataclass
class SharedDecl:
    """A static ``__shared__`` declaration of a kernel."""

    line: int
    ctype: str
    align: int
    name: str
    dims: List[str]


class CudaContext:
    """A ``.cu`` source as the PK and DT rules read it."""

    language = "cu"

    def __init__(self, path: str, source: str, project=None):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.code = _blank_comments(source)
        self.project = project
        self.consts: Dict[str, object] = {}
        for m in _CONSTEXPR_RE.finditer(self._file_scope()):
            try:
                self.consts[m.group(2)] = eval_c(m.group(3), self.consts)
            except CExprError:
                pass
        self.functions: Dict[str, List[CudaFunction]] = {}
        self._collect_functions()

    # ---- structure
    def line_of(self, offset: int) -> int:
        return self.code.count("\n", 0, offset) + 1

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def _file_scope(self) -> str:
        """The code outside every brace pair opened by a function, struct
        or class (namespaces and extern "C" blocks stay in)."""
        out, depth_stack, i, code = [], [], 0, self.code
        for m in re.finditer(r"[{}]", code):
            j = m.start()
            if code[j] == "{":
                head = code[max(0, j - 80):j]
                keep = bool(re.search(r"(namespace\s*\w*|extern\s+\"C\")\s*$", head))
                if not depth_stack or all(depth_stack):
                    out.append(code[i:j])
                depth_stack.append(keep)
            else:
                if depth_stack:
                    depth_stack.pop()
                if not depth_stack or all(depth_stack):
                    i = j + 1
        out.append(code[i:])
        return "".join(out)

    def _collect_functions(self) -> None:
        code = self.code
        for m in re.finditer(r"\b(\w+)\s*\(", code):
            name = m.group(1)
            if name in ("if", "for", "while", "switch", "return", "sizeof",
                        "__launch_bounds__", "__align__", "static_cast",
                        "reinterpret_cast", "defined", "decltype"):
                continue
            close = _match(code, m.end() - 1, "(", ")")
            rest = code[close:close + 200]
            body_m = re.match(r"\s*(?:const\s*)?\{", rest)
            if not body_m:
                continue
            # a definition: the text before the name is its return type
            line_start = code.rfind(";", 0, m.start())
            line_start = max(line_start, code.rfind("}", 0, m.start()),
                             code.rfind("{", 0, m.start()))
            decl = code[line_start + 1:m.start()]
            if re.search(r"[=.>]\s*$", decl) or "return" in decl.split():
                continue  # a call, not a definition
            if not re.search(r"\w", decl):
                continue
            bstart = close + body_m.end() - 1
            bend = _match(code, bstart, "{", "}")
            params: List[Tuple[str, str]] = []
            tm = list(_TEMPLATE_RE.finditer(decl))
            if tm:
                t0 = line_start + 1 + tm[-1].end() - 1
                tclose = _match(code, t0, "<", ">")
                for part in split_top(code[t0 + 1:tclose - 1]):
                    bits = part.split()
                    if len(bits) >= 2:
                        params.append((" ".join(bits[:-1]), bits[-1]))
            lb = re.search(r"__launch_bounds__\s*\(", decl)
            bounds = None
            if lb:
                a0 = line_start + 1 + lb.end() - 1
                inner = code[a0 + 1:_match(code, a0, "(", ")") - 1]
                bounds = split_top(inner)[0]
            fn = CudaFunction(name=name, line=self.line_of(m.start()), params=params,
                              body=code[bstart:bend], body_start=bstart,
                              is_kernel="__global__" in decl, launch_bounds=bounds)
            self.functions.setdefault(name, []).append(fn)

    def kernels(self) -> List[CudaFunction]:
        return [f for fs in self.functions.values() for f in fs if f.is_kernel]

    def shared_decls(self, fn: CudaFunction) -> Tuple[List[SharedDecl], bool]:
        """(static ``__shared__`` declarations of ``fn``, whether it also
        declares ``extern __shared__``: dynamic shared memory, sized at
        launch)."""
        out: List[SharedDecl] = []
        dynamic = False
        for m in _SHARED_RE.finditer(fn.body):
            if m.group(1):
                dynamic = True
                continue
            line = self.line_of(fn.body_start + m.start())
            for decl in split_top(m.group(4)):
                name = re.match(r"\s*(\w+)", decl)
                if not name:
                    continue
                dims = re.findall(r"\[([^\]]*)\]", decl)
                out.append(SharedDecl(line=line, ctype=" ".join(m.group(3).split()),
                                      align=int(m.group(2) or 0), name=name.group(1),
                                      dims=dims))
        return out, dynamic

    def local_env(self, fn: CudaFunction, binding: Dict[str, object]) -> Dict[str, object]:
        """The file's constants, ``binding`` and the body's own constexpr
        integers (in order; one that does not evaluate is left out)."""
        env = dict(self.consts)
        env.update(binding)
        for m in _CONSTEXPR_RE.finditer(fn.body):
            try:
                env[m.group(2)] = eval_c(m.group(3), env)
            except CExprError:
                pass
        return env

    # ---- launches and instantiations
    def calls(self, fn: CudaFunction) -> List[Tuple[str, List[str], bool, int, str]]:
        """(callee, template arguments, is a launch, line, launch config) of
        each template call ``name<...>(`` and launch ``name<...><<<...>>>``
        in ``fn``'s body."""
        out = []
        body = fn.body
        for m in re.finditer(r"\b(\w+)\s*<", body):
            name = m.group(1)
            if name not in self.functions:
                continue
            lt = m.end() - 1
            gt = _match(body, lt, "<", ">")
            after = body[gt:gt + 4].lstrip()
            args = split_top(body[lt + 1:gt - 1])
            line = self.line_of(fn.body_start + m.start())
            if after.startswith("<<<"):
                cfg_start = body.index("<<<", gt) + 3
                cfg_end = body.index(">>>", cfg_start)
                out.append((name, args, True, line, body[cfg_start:cfg_end]))
            elif after.startswith("("):
                out.append((name, args, False, line, ""))
        for m in re.finditer(r"\b(\w+)\s*<<<", body):  # launches of plain kernels
            if m.group(1) in self.functions:
                cfg_end = body.index(">>>", m.end())
                out.append((m.group(1), [], True,
                            self.line_of(fn.body_start + m.start()), body[m.end():cfg_end]))
        return out

    def instantiations(self) -> Dict[str, List[Tuple[Dict[str, object], int]]]:
        """Kernel name -> [(template binding, line of the launch)] for every
        instantiation reachable from the non-template functions. A binding
        value is an int, or a type name as the source spells it."""
        found: Dict[str, List[Tuple[Dict[str, object], int]]] = {}
        seen: Set[Tuple[str, Tuple]] = set()
        work: List[Tuple[CudaFunction, Dict[str, object], int]] = [
            (f, {}, f.line) for fs in self.functions.values() for f in fs
            if not f.params]
        while work:
            fn, binding, line = work.pop()
            key = (fn.name, tuple(sorted((k, str(v)) for k, v in binding.items())))
            if key in seen:
                continue
            seen.add(key)
            if fn.is_kernel:
                found.setdefault(fn.name, []).append((binding, line))
            env = self.local_env(fn, binding)
            for callee, args, _, cline, _ in self.calls(fn):
                for target in self.functions[callee]:
                    if len(target.params) != len(args) or not target.params:
                        continue
                    new: Dict[str, object] = {}
                    for (kind, pname), arg in zip(target.params, args, strict=True):
                        if kind in ("typename", "class"):
                            new[pname] = binding.get(arg, arg)
                        else:
                            try:
                                new[pname] = eval_c(arg, env)
                            except CExprError:
                                new[pname] = None
                    if any(v is None for v in new.values()):
                        continue
                    work.append((target, new, cline))
            for callee, args, is_launch, cline, _ in self.calls(fn):
                if is_launch and not args:
                    for target in self.functions[callee]:
                        if not target.params:
                            work.append((target, {}, cline))
        return found
