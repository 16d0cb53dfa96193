"""jsmini: a small ECMAScript-subset interpreter, enough to EXECUTE widgets.js.

Why this exists: the CI image ships no JavaScript runtime at all (no node, no
browser, no embeddable engine), yet VERDICT r3 item 9 is right that grepping
GLSL strings is not testing — the GUI's layout math, Pmt plumbing, 2D renderers
and GL call sequences should run as code. This module interprets the exact
dialect ``gui/widgets.js`` is written in:

- statements: const/let/var, function decls/exprs, arrow functions, return,
  if/else, for(;;), for…of, while, break/continue, throw, try/catch,
  switch/case, blocks;
- expressions: assignment (incl. ``+=`` family), ternary, ``||`` ``&&`` ``??``,
  comparisons, arithmetic, unary, member/computed access, calls, ``new`` with
  prototypes, object literals (computed keys, shorthand methods), array
  literals, spread in calls, template literals, regex literals;
- runtime: closures, ``this`` binding, prototype chains, Math/JSON/Object/
  Array/Number bridges, Float32Array/Uint8Array, string methods, and
  stub-friendly host objects (document/canvas/WebGL recorders live in
  ``tests/test_gui_js.py``).

Async is deliberately degenerate: ``async function`` behaves synchronously and
``await x`` unwraps an already-resolved promise — the test harness provides a
SYNCHRONOUS ``fetch`` bridge to the real control-port server, so Handle methods
run to completion inline. ``setTimeout`` invokes its callback immediately and
returns 0 (pollPeriodically-style loops must be driven with bounded fns in
tests).

This is an interpreter for a trusted, in-repo file — not a sandbox.
"""

from __future__ import annotations

import json as _json
import math as _math
import re as _re
from typing import Any, Dict, List, Optional

__all__ = ["Interp", "JSError", "JSObject", "JSFunction", "UNDEF"]


class JSError(Exception):
    def __init__(self, value):
        super().__init__(str(value))
        self.value = value


class _Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEF = _Undefined()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------
_PUNCT = sorted([
    "===", "!==", "**=", "...", ">>>", "=>", "==", "!=", "<=", ">=", "&&",
    "||", "??", "++", "--", "+=", "-=", "*=", "/=", "%=", "**", "?.",
    ">>", "<<",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/", "%",
    "=", "!", "?", ":", ".", "`", "&", "|", "^", "~",
], key=len, reverse=True)

_KEYWORDS = {
    "const", "let", "var", "function", "return", "if", "else", "for", "of",
    "while", "break", "continue", "new", "typeof", "instanceof", "in", "throw",
    "try", "catch", "finally", "switch", "case", "default", "async", "await",
    "true", "false", "null", "undefined", "this", "delete", "do",
}

_ID_RE = _re.compile(r"[A-Za-z_$][A-Za-z0-9_$]*")
_NUM_RE = _re.compile(r"(?:0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


class Tok:
    __slots__ = ("kind", "val", "pos")

    def __init__(self, kind, val, pos):
        self.kind, self.val, self.pos = kind, val, pos

    def __repr__(self):
        return f"Tok({self.kind},{self.val!r})"


def tokenize(src: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c in "'\"":
            j, buf = i + 1, []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    buf.append(_unescape(src[j + 1]))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            toks.append(Tok("str", "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            # template literal → tokens: tpl with list of (isExpr, text/tokens)
            parts, buf, j = [], [], i + 1
            while j < n and src[j] != "`":
                if src.startswith("${", j):
                    parts.append((False, "".join(buf)))
                    buf = []
                    depth, k = 1, j + 2
                    while k < n and depth:
                        if src[k] == "{":
                            depth += 1
                        elif src[k] == "}":
                            depth -= 1
                        k += 1
                    parts.append((True, src[j + 2:k - 1]))
                    j = k
                elif src[j] == "\\":
                    buf.append(_unescape(src[j + 1]))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            parts.append((False, "".join(buf)))
            toks.append(Tok("tpl", parts, i))
            i = j + 1
            continue
        if c == "/" and _regex_ok(toks):
            j, buf, in_cls = i + 1, [], False
            while j < n:
                ch = src[j]
                if ch == "\\":
                    buf.append(src[j:j + 2])
                    j += 2
                    continue
                if ch == "[":
                    in_cls = True
                elif ch == "]":
                    in_cls = False
                elif ch == "/" and not in_cls:
                    break
                buf.append(ch)
                j += 1
            j += 1
            flags = ""
            while j < n and src[j].isalpha():
                flags += src[j]
                j += 1
            toks.append(Tok("regex", ("".join(buf), flags), i))
            i = j
            continue
        m = _NUM_RE.match(src, i)
        if m and (c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit())):
            t = m.group(0)
            toks.append(Tok("num", float(int(t, 16)) if t[:2].lower() == "0x"
                            else float(t), i))
            i = m.end()
            continue
        m = _ID_RE.match(src, i)
        if m:
            w = m.group(0)
            toks.append(Tok(w if w in _KEYWORDS else "id", w, i))
            i = m.end()
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(Tok(p, p, i))
                i += len(p)
                break
        else:
            raise SyntaxError(f"jsmini: unexpected char {c!r} at {i}")
    toks.append(Tok("eof", None, n))
    return toks


def _unescape(ch: str) -> str:
    return {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "b": "\b"}.get(ch, ch)


def _regex_ok(toks: List[Tok]) -> bool:
    """A '/' starts a regex when the previous token cannot end an expression."""
    if not toks:
        return True
    t = toks[-1]
    if t.kind in ("num", "str", "id", "regex", "tpl"):
        return False
    if t.kind in (")", "]", "this", "true", "false", "null", "undefined"):
        return False
    return True


# ---------------------------------------------------------------------------
# parser (Pratt for expressions, recursive descent for statements)
# ---------------------------------------------------------------------------
class P:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind) -> Tok:
        t = self.next()
        if t.kind != kind:
            raise SyntaxError(f"jsmini: expected {kind}, got {t} @{t.pos}")
        return t

    def at(self, kind) -> bool:
        return self.peek().kind == kind

    def eat(self, kind) -> bool:
        if self.at(kind):
            self.next()
            return True
        return False

    # ---- statements -------------------------------------------------------
    def program(self):
        body = []
        while not self.at("eof"):
            body.append(self.statement())
        return ("block", body)

    def statement(self):
        t = self.peek()
        k = t.kind
        if k == "{":
            self.next()
            body = []
            while not self.eat("}"):
                body.append(self.statement())
            return ("block", body)
        if k in ("const", "let", "var"):
            self.next()
            decls = []
            while True:
                if self.at("["):            # const [a, , b] = expr
                    self.next()
                    names = []
                    while not self.eat("]"):
                        if self.at(","):
                            self.next()
                            names.append(None)
                            continue
                        names.append(self.expect("id").val)
                        self.eat(",")
                    self.expect("=")
                    decls.append(("arr", names, self.assign()))
                else:
                    name = self.expect("id").val
                    init = self.assign() if self.eat("=") else ("undef",)
                    decls.append(("one", name, init))
                if not self.eat(","):
                    break
            self.eat(";")
            return ("decl", decls)
        if k in ("function",) or (k == "async" and self.peek(1).kind == "function"):
            self.eat("async")
            self.next()
            name = self.expect("id").val
            fn = self.fn_rest(name)
            return ("decl", [("one", name, fn)])
        if k == "return":
            self.next()
            val = ("undef",) if self.at(";") or self.at("}") else self.expr()
            self.eat(";")
            return ("return", val)
        if k == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self.statement()
            els = self.statement() if self.eat("else") else None
            return ("if", cond, then, els)
        if k == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return ("while", cond, self.statement())
        if k == "do":
            self.next()
            body = self.statement()
            self.expect("while")
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            self.eat(";")
            return ("dowhile", cond, body)
        if k == "for":
            self.next()
            self.expect("(")
            if self.peek().kind in ("const", "let", "var") and \
                    (self.peek(1).kind == "[" or self.peek(2).kind == "of"):
                self.next()
                if self.at("["):
                    self.next()
                    names = []
                    while not self.eat("]"):
                        if self.at(","):
                            self.next()
                            names.append(None)
                            continue
                        names.append(self.expect("id").val)
                        self.eat(",")
                    tgt = ("arr", names)
                else:
                    tgt = ("one", self.expect("id").val)
                self.expect("of")
                it = self.expr()
                self.expect(")")
                return ("forof", tgt, it, self.statement())
            init = ("empty",) if self.eat(";") else self.statement()
            # statement() consumed its own ';'
            cond = ("lit", True) if self.at(";") else self.expr()
            self.expect(";")
            step = ("undef",) if self.at(")") else self.expr()
            self.expect(")")
            return ("for", init, cond, step, self.statement())
        if k == "break":
            self.next()
            self.eat(";")
            return ("break",)
        if k == "continue":
            self.next()
            self.eat(";")
            return ("continue",)
        if k == "throw":
            self.next()
            v = self.expr()
            self.eat(";")
            return ("throw", v)
        if k == "try":
            self.next()
            body = self.statement()
            cname, cbody, fbody = None, None, None
            if self.eat("catch"):
                if self.eat("("):
                    cname = self.expect("id").val
                    self.expect(")")
                cbody = self.statement()
            if self.eat("finally"):
                fbody = self.statement()
            return ("try", body, cname, cbody, fbody)
        if k == "switch":
            self.next()
            self.expect("(")
            disc = self.expr()
            self.expect(")")
            self.expect("{")
            cases, cur, is_default = [], None, False
            while not self.eat("}"):
                if self.eat("case"):
                    test = self.expr()
                    self.expect(":")
                    cur = []
                    cases.append((test, cur))
                elif self.eat("default"):
                    self.expect(":")
                    cur = []
                    cases.append((None, cur))
                else:
                    cur.append(self.statement())
            return ("switch", disc, cases)
        if k == ";":
            self.next()
            return ("empty",)
        e = self.expr()
        self.eat(";")
        return ("expr", e)

    # ---- functions --------------------------------------------------------
    def fn_rest(self, name):
        self.expect("(")
        params = []
        while not self.eat(")"):
            params.append(self.expect("id").val)
            self.eat(",")
        body = self.statement()
        return ("fn", name, params, body, False)

    # ---- expressions ------------------------------------------------------
    def expr(self):
        e = self.assign()
        while self.at(","):
            # sequence only inside for(;;) steps in this dialect
            self.next()
            e = ("seq", e, self.assign())
        return e

    def assign(self):
        left = self.ternary()
        t = self.peek().kind
        if t in ("=", "+=", "-=", "*=", "/=", "%="):
            self.next()
            right = self.assign()
            return ("assign", t, left, right)
        return left

    def ternary(self):
        c = self.nullish()
        if self.eat("?"):
            a = self.assign()
            self.expect(":")
            b = self.assign()
            return ("cond", c, a, b)
        return c

    def nullish(self):
        e = self.or_()
        while self.at("??"):
            self.next()
            e = ("??", e, self.or_())
        return e

    def or_(self):
        e = self.and_()
        while self.at("||"):
            self.next()
            e = ("||", e, self.and_())
        return e

    def and_(self):
        e = self.eq()
        while self.at("&&"):
            self.next()
            e = ("&&", e, self.eq())
        return e

    def eq(self):
        e = self.rel()
        while self.peek().kind in ("===", "!==", "==", "!="):
            op = self.next().kind
            e = ("bin", op, e, self.rel())
        return e

    def rel(self):
        e = self.shift()
        while self.peek().kind in ("<", ">", "<=", ">=", "instanceof", "in"):
            op = self.next().kind
            e = ("bin", op, e, self.shift())
        return e

    def shift(self):
        e = self.add()
        while self.peek().kind in (">>>", ">>", "<<"):
            op = self.next().kind
            e = ("bin", op, e, self.add())
        return e

    def add(self):
        e = self.mul()
        while self.peek().kind in ("+", "-"):
            op = self.next().kind
            e = ("bin", op, e, self.mul())
        return e

    def mul(self):
        e = self.unary()
        while self.peek().kind in ("*", "/", "%", "**"):
            op = self.next().kind
            e = ("bin", op, e, self.unary())
        return e

    def unary(self):
        t = self.peek().kind
        if t in ("!", "-", "+", "typeof", "delete"):
            self.next()
            return ("unary", t, self.unary())
        if t in ("++", "--"):
            self.next()
            return ("preinc", t, self.unary())
        if t == "await":
            self.next()
            return ("await", self.unary())
        if t == "new":
            self.next()
            callee = self.postfix(self.primary(), no_call=True)
            args = []
            if self.eat("("):
                while not self.eat(")"):
                    args.append(self.assign())
                    self.eat(",")
            return self.postfix(("new", callee, args))   # new X().method()
        return self.postfix(self.primary())

    def postfix(self, e, no_call=False):
        while True:
            t = self.peek().kind
            if t == ".":
                self.next()
                name = self.next().val        # ids or keywords as prop names
                e = ("member", e, ("lit", name))
            elif t == "[":
                self.next()
                idx = self.expr()
                self.expect("]")
                e = ("member", e, idx)
            elif t == "(" and not no_call:
                self.next()
                args = []
                while not self.eat(")"):
                    if self.eat("..."):
                        args.append(("spread", self.assign()))
                    else:
                        args.append(self.assign())
                    self.eat(",")
                e = ("call", e, args)
            elif t in ("++", "--"):
                self.next()
                e = ("postinc", t, e)
            else:
                return e

    def _arrow_ahead(self) -> int:
        """From a '(' at self.i, find whether '=>' follows the matching ')'."""
        depth, j = 0, self.i
        while j < len(self.toks):
            k = self.toks[j].kind
            if k == "(":
                depth += 1
            elif k == ")":
                depth -= 1
                if depth == 0:
                    return j + 1 if self.toks[j + 1].kind == "=>" else -1
            elif k == "eof":
                return -1
            j += 1
        return -1

    def primary(self):
        t = self.next()
        k = t.kind
        if k == "num":
            return ("lit", t.val)
        if k == "str":
            return ("lit", t.val)
        if k == "tpl":
            parts = []
            for is_expr, txt in t.val:
                if is_expr:
                    sub = P(tokenize(txt))
                    parts.append(("e", sub.expr()))
                else:
                    parts.append(("s", txt))
            return ("tpl", parts)
        if k == "regex":
            return ("regex", t.val[0], t.val[1])
        if k == "true":
            return ("lit", True)
        if k == "false":
            return ("lit", False)
        if k == "null":
            return ("lit", None)
        if k == "undefined":
            return ("undef",)
        if k == "this":
            return ("this",)
        if k == "id":
            if self.at("=>"):
                self.next()
                return self._arrow_body([t.val])
            return ("name", t.val)
        if k == "async":
            # async arrow / async function expression
            if self.at("function"):
                self.next()
                name = self.next().val if self.at("id") else None
                return self.fn_rest(name)
            if self.at("(") and self._arrow_ahead() >= 0:
                self.next()
                params = []
                while not self.eat(")"):
                    params.append(self.expect("id").val)
                    self.eat(",")
                self.expect("=>")
                return self._arrow_body(params)
            if self.at("id") and self.peek(1).kind == "=>":
                name = self.next().val
                self.next()
                return self._arrow_body([name])
        if k == "function":
            name = self.next().val if self.at("id") else None
            return self.fn_rest(name)
        if k == "(":
            if self._arrow_ahead_from_here():
                params = []
                while not self.eat(")"):
                    params.append(self.expect("id").val)
                    self.eat(",")
                self.expect("=>")
                return self._arrow_body(params)
            e = self.expr()
            self.expect(")")
            return e
        if k == "[":
            items = []
            while not self.eat("]"):
                if self.eat("..."):
                    items.append(("spread", self.assign()))
                else:
                    items.append(self.assign())
                self.eat(",")
            return ("array", items)
        if k == "{":
            props = []
            while not self.eat("}"):
                if self.at("["):                  # computed key
                    self.next()
                    key = self.expr()
                    self.expect("]")
                    self.expect(":")
                    props.append(("computed", key, self.assign()))
                else:
                    kt = self.next()
                    name = kt.val
                    if self.at("("):              # shorthand method
                        props.append(("kv", name, self.fn_rest(name)))
                    elif self.eat(":"):
                        props.append(("kv", name, self.assign()))
                    else:                          # shorthand {x}
                        props.append(("kv", name, ("name", name)))
                self.eat(",")
            return ("object", props)
        raise SyntaxError(f"jsmini: unexpected token {t} @{t.pos}")

    def _arrow_ahead_from_here(self) -> bool:
        depth, j = 1, self.i
        while j < len(self.toks):
            k = self.toks[j].kind
            if k == "(":
                depth += 1
            elif k == ")":
                depth -= 1
                if depth == 0:
                    return self.toks[j + 1].kind == "=>"
            elif k == "eof":
                return False
            j += 1
        return False

    def _arrow_body(self, params):
        if self.at("{"):
            body = self.statement()
            return ("fn", None, params, body, True)
        return ("fn", None, params, ("return", self.assign()), True)


# ---------------------------------------------------------------------------
# runtime values
# ---------------------------------------------------------------------------
class JSObject:
    def __init__(self, proto: Optional["JSObject"] = None):
        self.props: Dict[str, Any] = {}
        self.proto = proto

    def get(self, name):
        o = self
        while o is not None:
            if name in o.props:
                return o.props[name]
            o = o.proto
        return UNDEF

    def set(self, name, val):
        self.props[name] = val

    def __repr__(self):
        return "[object Object]"


class JSFunction(JSObject):
    def __init__(self, node, env, interp, is_arrow=False, this=None):
        super().__init__()
        self.node = node
        self.env = env
        self.interp = interp
        self.is_arrow = is_arrow
        self.bound_this = this
        self.props["prototype"] = JSObject()

    def call(self, this, args):
        _, _name, params, body, _arrow = self.node
        env = Env(self.env)
        if self.is_arrow:
            this = self.bound_this
        env.declare("this", this)
        env.declare("arguments", list(args))
        for i, p in enumerate(params):
            env.declare(p, args[i] if i < len(args) else UNDEF)
        try:
            self.interp.exec_stmt(body, env)
        except _Return as r:
            return r.value
        return UNDEF


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def declare(self, name, val):
        self.vars[name] = val

    def get(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        raise JSError(f"ReferenceError: {name} is not defined")

    def set(self, name, val):
        e = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = val
                return
            e = e.parent
        raise JSError(f"ReferenceError: {name} is not defined")


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class TypedArray(list):
    """Float32Array/Uint8Array stand-in: a list with JS-ish semantics."""

    def __init__(self, arg=0, clamp=None):
        if isinstance(arg, (int, float)):
            super().__init__([0.0] * int(arg))
        else:
            super().__init__(float(v) for v in arg)
        self.clamp = clamp

    @property
    def length(self):
        return len(self)


# ---------------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------------
class Interp:
    def __init__(self, hosts: Optional[Dict[str, Any]] = None):
        self.genv = Env()
        g = self.genv
        g.declare("this", UNDEF)
        g.declare("Infinity", _math.inf)
        g.declare("NaN", _math.nan)
        g.declare("globalThis", UNDEF)
        self._install_builtins()
        for k, v in (hosts or {}).items():
            g.declare(k, v)

    # ---- public API -------------------------------------------------------
    def run(self, src: str):
        ast = P(tokenize(src)).program()
        # top-level declarations must land in the GLOBAL env, not a block scope
        self._hoist(ast[1], self.genv)
        for s in ast[1]:
            self.exec_stmt(s, self.genv)

    def eval(self, src: str):
        p = P(tokenize(src))
        e = p.expr()
        return self.eval_expr(e, self.genv)

    def get(self, name):
        return self.genv.get(name)

    def call(self, fn, this, *args):
        return self._call(fn, this, list(args))

    # ---- builtins ---------------------------------------------------------
    def _install_builtins(self):
        g = self.genv

        math_obj = JSObject()
        for name in ("floor", "ceil", "sqrt", "sin", "cos", "tan", "atan2",
                     "log", "log2", "log10", "exp", "pow"):
            math_obj.set(name, getattr(_math, name))
        math_obj.set("abs", abs)
        math_obj.set("max", lambda *a: max(a) if a else -_math.inf)
        math_obj.set("min", lambda *a: min(a) if a else _math.inf)
        math_obj.set("round", lambda x: _math.floor(x + 0.5))
        math_obj.set("random", __import__("random").random)
        math_obj.set("PI", _math.pi)
        g.declare("Math", math_obj)

        json_obj = JSObject()
        json_obj.set("stringify", lambda v, *a: _json.dumps(_to_py(v)))
        json_obj.set("parse", lambda s: _from_py(_json.loads(s)))
        g.declare("JSON", json_obj)

        obj_ns = JSObject()
        obj_ns.set("keys", lambda o: list(o.props.keys()))
        obj_ns.set("entries", lambda o: [[k, v] for k, v in o.props.items()])
        obj_ns.set("values", lambda o: list(o.props.values()))
        obj_ns.set("assign", _object_assign)
        g.declare("Object", obj_ns)

        arr_ns = JSObject()
        arr_ns.set("from", lambda it, fn=None: [
            self._call(fn, UNDEF, [v, i]) if fn else v
            for i, v in enumerate(list(it))])
        arr_ns.set("isArray", lambda v: isinstance(v, list))
        g.declare("Array", arr_ns)

        g.declare("Number", _NumberNS())

        g.declare("parseFloat", _parse_float)
        g.declare("parseInt", _parse_int)
        g.declare("isNaN", lambda v: not isinstance(v, (int, float))
                  or _math.isnan(_to_num(v)))
        g.declare("Float32Array", _mk_typed(None))
        g.declare("Uint8Array", _mk_typed("u8"))
        g.declare("String", lambda v=UNDEF: _to_str(v))
        g.declare("Boolean", _truthy)
        g.declare("Error", _mk_error)
        g.declare("console", _console())
        g.declare("setTimeout", lambda fn=None, ms=0, *a:
                  (self._call(fn, UNDEF, list(a)) if fn is not UNDEF and fn
                   else None, 0)[1])
        g.declare("Promise", _mk_promise(self))
        g.declare("fetch", _not_wired("fetch"))
        g.declare("document", _not_wired("document"))
        g.declare("window", UNDEF)
        g.declare("module", UNDEF)

    # ---- statement execution ---------------------------------------------
    def exec_stmt(self, node, env):
        op = node[0]
        if op == "block":
            benv = Env(env)
            self._hoist(node[1], benv)
            for s in node[1]:
                self.exec_stmt(s, benv)
        elif op == "decl":
            for d in node[1]:
                if d[0] == "one":
                    env.declare(d[1], self.eval_expr(d[2], env))
                else:
                    val = list(self.eval_expr(d[2], env))
                    for i, nm in enumerate(d[1]):
                        if nm is not None:
                            env.declare(nm, val[i] if i < len(val) else UNDEF)
        elif op == "expr":
            self.eval_expr(node[1], env)
        elif op == "return":
            raise _Return(self.eval_expr(node[1], env))
        elif op == "if":
            if _truthy(self.eval_expr(node[1], env)):
                self.exec_stmt(node[2], env)
            elif node[3] is not None:
                self.exec_stmt(node[3], env)
        elif op == "while":
            while _truthy(self.eval_expr(node[1], env)):
                try:
                    self.exec_stmt(node[2], env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif op == "dowhile":
            while True:
                try:
                    self.exec_stmt(node[2], env)
                except _Break:
                    break
                except _Continue:
                    pass
                if not _truthy(self.eval_expr(node[1], env)):
                    break
        elif op == "for":
            fenv = Env(env)
            if node[1][0] != "empty":
                self.exec_stmt(node[1], fenv)
            while _truthy(self.eval_expr(node[2], fenv)):
                try:
                    self.exec_stmt(node[4], fenv)
                except _Break:
                    break
                except _Continue:
                    pass
                self.eval_expr(node[3], fenv)
        elif op == "forof":
            it = self.eval_expr(node[2], env)
            for v in _iterate(it):
                fenv = Env(env)
                if node[1][0] == "one":
                    fenv.declare(node[1][1], v)
                else:
                    vl = list(v)
                    for i, nm in enumerate(node[1][1]):
                        if nm is not None:
                            fenv.declare(nm, vl[i] if i < len(vl) else UNDEF)
                try:
                    self.exec_stmt(node[3], fenv)
                except _Break:
                    break
                except _Continue:
                    continue
        elif op == "break":
            raise _Break()
        elif op == "continue":
            raise _Continue()
        elif op == "throw":
            raise JSError(self.eval_expr(node[1], env))
        elif op == "try":
            _, body, cname, cbody, fbody = node
            try:
                self.exec_stmt(body, env)
            except (JSError, ZeroDivisionError, TypeError, ValueError,
                    AttributeError, KeyError, IndexError) as e:
                if cbody is None:
                    raise               # try/finally: the finally clause below
                    #                     still runs, then the error propagates
                cenv = Env(env)
                if cname:
                    cenv.declare(cname, e.value if isinstance(e, JSError)
                                 else _mk_error(str(e)))
                self.exec_stmt(cbody, cenv)
            finally:
                if fbody is not None:
                    self.exec_stmt(fbody, env)
        elif op == "switch":
            disc = self.eval_expr(node[1], env)
            matched = False
            try:
                for test, stmts in node[2]:
                    if not matched:
                        if test is None:
                            matched = True
                        elif _strict_eq(self.eval_expr(test, env), disc):
                            matched = True
                    if matched:
                        for s in stmts:
                            self.exec_stmt(s, env)
            except _Break:
                pass
        elif op == "empty":
            pass
        else:
            raise SyntaxError(f"jsmini: unknown stmt {op}")

    def _hoist(self, stmts, env):
        for s in stmts:
            if s[0] == "decl":
                for d in s[1]:
                    if d[0] == "one" and d[2][0] == "fn":
                        env.declare(d[1], self.eval_expr(d[2], env))

    # ---- expression evaluation --------------------------------------------
    def eval_expr(self, node, env):
        op = node[0]
        if op == "lit":
            return node[1]
        if op == "undef":
            return UNDEF
        if op == "name":
            return env.get(node[1])
        if op == "this":
            try:
                return env.get("this")
            except JSError:
                return UNDEF
        if op == "tpl":
            return "".join(_to_str(self.eval_expr(p[1], env))
                           if p[0] == "e" else p[1] for p in node[1])
        if op == "regex":
            return _JSRegex(node[1], node[2])
        if op == "fn":
            return JSFunction(node, env, self, is_arrow=node[4],
                              this=(env.get("this")
                                    if node[4] and _has(env, "this") else None))
        if op == "array":
            out = []
            for it in node[1]:
                if it[0] == "spread":
                    out.extend(_iterate(self.eval_expr(it[1], env)))
                else:
                    out.append(self.eval_expr(it, env))
            return out
        if op == "object":
            o = JSObject()
            for p in node[1]:
                if p[0] == "computed":
                    o.set(_to_str(self.eval_expr(p[1], env)),
                          self.eval_expr(p[2], env))
                else:
                    o.set(p[1], self.eval_expr(p[2], env))
            return o
        if op == "member":
            obj = self.eval_expr(node[1], env)
            key = self.eval_expr(node[2], env)
            return self._get_member(obj, key)
        if op == "call":
            callee = node[1]
            args = []
            for a in node[2]:
                if a[0] == "spread":
                    args.extend(_iterate(self.eval_expr(a[1], env)))
                else:
                    args.append(self.eval_expr(a, env))
            if callee[0] == "member":
                obj = self.eval_expr(callee[1], env)
                key = self.eval_expr(callee[2], env)
                fn = self._get_member(obj, key)
                if callable(fn) and not isinstance(fn, (JSFunction,)):
                    return fn(*args)
                return self._call(fn, obj, args)
            fn = self.eval_expr(callee, env)
            return self._call(fn, UNDEF, args)
        if op == "new":
            ctor = self.eval_expr(node[1], env)
            args = [self.eval_expr(a, env) for a in node[2]]
            if callable(ctor) and not isinstance(ctor, JSFunction):
                return ctor(*args)
            obj = JSObject(proto=ctor.get("prototype"))
            r = self._call(ctor, obj, args)
            return r if isinstance(r, JSObject) and r is not UNDEF else obj
        if op == "assign":
            return self._assign(node, env)
        if op == "cond":
            return (self.eval_expr(node[2], env)
                    if _truthy(self.eval_expr(node[1], env))
                    else self.eval_expr(node[3], env))
        if op == "??":
            left = self.eval_expr(node[1], env)
            return (self.eval_expr(node[2], env)
                    if left is None or left is UNDEF else left)
        if op == "||":
            left = self.eval_expr(node[1], env)
            return left if _truthy(left) else self.eval_expr(node[2], env)
        if op == "&&":
            left = self.eval_expr(node[1], env)
            return self.eval_expr(node[2], env) if _truthy(left) else left
        if op == "bin":
            return self._binop(node[1], self.eval_expr(node[2], env),
                               self.eval_expr(node[3], env))
        if op == "unary":
            k = node[1]
            if k == "typeof":
                try:
                    v = self.eval_expr(node[2], env)
                except JSError:
                    return "undefined"
                return _typeof(v)
            if k == "delete":
                tgt = node[2]
                if tgt[0] == "member":
                    obj = self.eval_expr(tgt[1], env)
                    key = _to_str(self.eval_expr(tgt[2], env))
                    if isinstance(obj, JSObject):
                        obj.props.pop(key, None)
                    elif isinstance(obj, dict):
                        obj.pop(key, None)
                return True
            v = self.eval_expr(node[2], env)
            if k == "!":
                return not _truthy(v)
            if k == "-":
                return -_to_num(v)
            if k == "+":
                return _to_num(v)
        if op in ("preinc", "postinc"):
            tgt = node[2]
            old = _to_num(self.eval_expr(tgt, env))
            new = old + (1 if node[1] == "++" else -1)
            self._assign(("assign", "=", tgt, ("lit", new)), env)
            return new if op == "preinc" else old
        if op == "await":
            v = self.eval_expr(node[1], env)
            if isinstance(v, JSObject) and v.get("__value__") is not UNDEF:
                return v.get("__value__")
            return v
        if op == "seq":
            self.eval_expr(node[1], env)
            return self.eval_expr(node[2], env)
        if op == "spread":
            raise SyntaxError("jsmini: spread outside call/array")
        raise SyntaxError(f"jsmini: unknown expr {op}")

    # ---- helpers ----------------------------------------------------------
    def _call(self, fn, this, args):
        if fn is UNDEF or fn is None:
            raise JSError("TypeError: not a function")
        if isinstance(fn, JSFunction):
            return fn.call(this, args)
        if callable(fn):
            return fn(*args)
        raise JSError(f"TypeError: {fn!r} is not a function")

    def _assign(self, node, env):
        _, op, tgt, rhs = node
        val = self.eval_expr(rhs, env)
        if op != "=":
            cur = self.eval_expr(tgt, env)
            val = self._binop(op[0], cur, val)
        if tgt[0] == "name":
            try:
                env.set(tgt[1], val)
            except JSError:
                env.declare(tgt[1], val)        # sloppy-mode global
            return val
        if tgt[0] == "member":
            obj = self.eval_expr(tgt[1], env)
            key = self.eval_expr(tgt[2], env)
            if isinstance(obj, JSObject):
                obj.set(_to_str(key), val)
            elif isinstance(obj, list):
                i = int(key)
                while len(obj) <= i:
                    obj.append(UNDEF)
                obj[i] = _to_num(val) if isinstance(obj, TypedArray) else val
            elif hasattr(obj, "__setitem__"):
                obj[_to_str(key) if isinstance(key, str) else int(key)] = val
            else:
                setattr(obj, _to_str(key), val)
            return val
        raise SyntaxError("jsmini: bad assignment target")

    def _get_member(self, obj, key):
        if obj is UNDEF or obj is None:
            raise JSError(f"TypeError: cannot read {key!r} of {obj!r}")
        if isinstance(key, float) and key.is_integer():
            key_i: Any = int(key)
        else:
            key_i = key
        if isinstance(obj, JSObject):
            v = obj.get(_to_str(key_i))
            if v is not UNDEF:
                return v
            return UNDEF
        if isinstance(obj, list):
            if isinstance(key_i, int):
                return obj[key_i] if 0 <= key_i < len(obj) else UNDEF
            return _array_method(self, obj, key_i)
        if isinstance(obj, str):
            if isinstance(key_i, int):
                return obj[key_i] if 0 <= key_i < len(obj) else UNDEF
            return _string_method(obj, key_i)
        if isinstance(obj, (int, float)):
            return _number_method(obj, key_i)
        if isinstance(obj, dict):
            return obj.get(key_i, UNDEF)
        # Python host object: attribute access (stubs live in the tests)
        v = getattr(obj, str(key_i), UNDEF)
        return v


# ---------------------------------------------------------------------------
# value semantics
# ---------------------------------------------------------------------------
def _has(env, name):
    e = env
    while e is not None:
        if name in e.vars:
            return True
        e = e.parent
    return False


def _truthy(v) -> bool:
    if v is UNDEF or v is None or v is False:
        return False
    if v is True:
        return True
    if isinstance(v, (int, float)):
        return v != 0 and not _math.isnan(v)
    if isinstance(v, str):
        return len(v) > 0
    return True


def _to_num(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if v is UNDEF:
        return _math.nan
    if v is None:
        return 0.0
    if isinstance(v, str):
        try:
            return float(v) if v.strip() else 0.0
        except ValueError:
            return _math.nan
    return _math.nan


def _fmt_num(x: float) -> str:
    if isinstance(x, bool):
        return "true" if x else "false"
    if x != x:
        return "NaN"
    if x == _math.inf:
        return "Infinity"
    if x == -_math.inf:
        return "-Infinity"
    if float(x).is_integer() and abs(x) < 1e21:
        return str(int(x))
    return repr(float(x))


def _to_str(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _fmt_num(float(v))
    if v is UNDEF:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, list):
        return ",".join("" if x is UNDEF or x is None else _to_str(x)
                        for x in v)
    if isinstance(v, JSError):
        return str(v)
    return str(v)


def _typeof(v) -> str:
    if v is UNDEF:
        return "undefined"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, JSFunction) or callable(v):
        return "function"
    return "object"


def _strict_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def _iterate(v):
    if isinstance(v, JSObject):
        raise JSError("TypeError: object is not iterable")
    return list(v)


def _binop_num(op, a, b):
    an, bn = _to_num(a), _to_num(b)
    if op == "-":
        return an - bn
    if op == "*":
        return an * bn
    if op == "/":
        if bn == 0:
            return _math.inf if an > 0 else (-_math.inf if an < 0 else _math.nan)
        return an / bn
    if op == "%":
        return _math.fmod(an, bn) if bn != 0 else _math.nan
    if op == "**":
        return an ** bn
    raise SyntaxError(op)


def _object_assign(target, *sources):
    for s in sources:
        if isinstance(s, JSObject):
            for k, v in s.props.items():
                target.set(k, v)
    return target


class _JSRegex:
    def __init__(self, pattern, flags):
        py = pattern
        f = 0
        if "i" in flags:
            f |= _re.I
        self.global_ = "g" in flags
        self.re = _re.compile(py, f)

    def test(self, s):
        return self.re.search(s) is not None


class _NumberNS:
    """``Number`` is both a conversion function and a namespace."""

    def __call__(self, v=UNDEF, *rest):
        return _to_num(v)                # .map(Number) passes (v, i, arr)

    @staticmethod
    def isFinite(v):
        return isinstance(v, (int, float)) and _math.isfinite(v)

    @staticmethod
    def isInteger(v):
        return isinstance(v, (int, float)) and float(v).is_integer()


def _parse_float(s):
    m = _re.match(r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", _to_str(s))
    return float(m.group(0)) if m else _math.nan


def _parse_int(s, base=10):
    base = int(base) if base else 10
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:base]
    m = _re.match(rf"\s*([+-]?)([{digits}]+)", _to_str(s), _re.I)
    if not m:
        return _math.nan               # JS: parse the maximal valid prefix
    return float(int(m.group(1) + m.group(2), base))


def _mk_typed(kind):
    def ctor(arg=0):
        t = TypedArray(arg, clamp=kind)
        return t
    ctor.js_name = "Float32Array" if kind is None else "Uint8Array"
    setattr(ctor, "from", lambda it, fn=None: TypedArray(
        [fn(v, float(i)) if fn else v for i, v in enumerate(list(it))],
        clamp=kind))
    setattr(ctor, "of", lambda *vs: TypedArray(list(vs), clamp=kind))
    return ctor


def _mk_error(msg=UNDEF):
    o = JSObject()
    o.set("message", _to_str(msg))
    return o


def _console():
    o = JSObject()
    o.set("log", lambda *a: None)
    o.set("warn", lambda *a: None)
    o.set("error", lambda *a: None)
    return o


def _mk_promise(interp):
    def ctor(executor=None):
        box = JSObject()
        box.set("__value__", UNDEF)

        def resolve(v=UNDEF):
            box.set("__value__", v)

        def reject(v=UNDEF):
            raise JSError(v)
        if executor is not None and executor is not UNDEF:
            interp._call(executor, UNDEF, [resolve, reject])
        return box
    return ctor


def _not_wired(name):
    def stub(*a, **k):
        raise JSError(f"{name} is not wired into this jsmini instance")
    return stub


# ---- method tables ---------------------------------------------------------
def _array_method(interp, arr, name):
    if name == "length":
        return float(len(arr))

    def map_(fn):
        return [interp._call(fn, UNDEF, [v, float(i), arr])
                for i, v in enumerate(arr)]

    def forEach(fn):
        for i, v in enumerate(list(arr)):
            interp._call(fn, UNDEF, [v, float(i), arr])
        return UNDEF

    def filter_(fn):
        return [v for i, v in enumerate(arr)
                if _truthy(interp._call(fn, UNDEF, [v, float(i), arr]))]

    table = {
        "push": lambda *vs: (arr.extend(vs), float(len(arr)))[1],
        "pop": lambda: arr.pop() if arr else UNDEF,
        "slice": lambda s=0, e=None: arr[int(s):(int(e) if e is not None
                                                 and e is not UNDEF else None)],
        "join": lambda sep=",": _to_str(sep).join(_to_str(v) for v in arr),
        "map": map_,
        "forEach": forEach,
        "filter": filter_,
        "indexOf": lambda v: float(arr.index(v)) if v in arr else -1.0,
        "includes": lambda v: v in arr,
        "concat": lambda *o: sum((list(x) if isinstance(x, list) else [x]
                                  for x in o), list(arr)),
        "fill": lambda v: ([arr.__setitem__(i, v) for i in range(len(arr))],
                           arr)[1],
        "reverse": lambda: (arr.reverse(), arr)[1],
        "sort": lambda fn=None: (arr.sort(
            key=_cmp_key(interp, fn) if fn else _to_num), arr)[1],
        "keys": lambda: [float(i) for i in range(len(arr))],
        "set": lambda src, off=0: [arr.__setitem__(int(off) + i, v)
                                   for i, v in enumerate(src)] and UNDEF,
        "subarray": lambda s=0, e=None: arr[int(s):(int(e) if e not in
                                                    (None, UNDEF) else None)],
    }
    v = table.get(name, UNDEF)
    return v


def _cmp_key(interp, fn):
    import functools

    def cmp(a, b):
        r = _to_num(interp._call(fn, UNDEF, [a, b]))
        return -1 if r < 0 else (1 if r > 0 else 0)
    return functools.cmp_to_key(cmp)


def _string_method(s, name):
    if name == "length":
        return float(len(s))
    table = {
        "replace": lambda pat, rep: _str_replace(s, pat, rep),
        "split": lambda sep: s.split(_to_str(sep)),
        "toUpperCase": lambda: s.upper(),
        "toLowerCase": lambda: s.lower(),
        "trim": lambda: s.strip(),
        "indexOf": lambda sub: float(s.find(_to_str(sub))),
        "includes": lambda sub: _to_str(sub) in s,
        "startsWith": lambda sub: s.startswith(_to_str(sub)),
        "endsWith": lambda sub: s.endswith(_to_str(sub)),
        "slice": lambda a=0, b=None: s[int(a):(int(b) if b not in
                                               (None, UNDEF) else None)],
        "charCodeAt": lambda i=0: float(ord(s[int(i)])),
        "padStart": lambda w, f=" ": s.rjust(int(w), _to_str(f)),
        "repeat": lambda k: s * int(k),
    }
    return table.get(name, UNDEF)


def _str_replace(s, pat, rep):
    def expand(m):
        if isinstance(rep, JSFunction):
            return _to_str(rep.interp._call(
                rep, UNDEF, [m.group(0), *m.groups()]))
        if callable(rep):
            return _to_str(rep(m.group(0), *m.groups()))
        out = _to_str(rep)
        out = out.replace("$&", m.group(0))
        for gi in range(len(m.groups()), 0, -1):
            out = out.replace(f"${gi}", m.group(gi) or "")
        return out
    if isinstance(pat, _JSRegex):
        count = 0 if pat.global_ else 1
        return pat.re.sub(expand, s, count=count)
    if isinstance(rep, JSFunction) or callable(rep):
        idx = s.find(_to_str(pat))
        if idx < 0:
            return s
        matched = _to_str(pat)
        val = (rep.interp._call(rep, UNDEF, [matched])
               if isinstance(rep, JSFunction) else rep(matched))
        return s[:idx] + _to_str(val) + s[idx + len(matched):]
    return s.replace(_to_str(pat), _to_str(rep), 1)


def _number_method(x, name):
    table = {
        "toFixed": lambda d=0: f"{float(x):.{int(d)}f}",
        "toString": lambda base=10: (_fmt_num(float(x)) if base == 10 else
                                     _to_base(int(x), int(base))),
    }
    return table.get(name, UNDEF)


def _to_base(v, base):
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    if v == 0:
        return "0"
    neg, v = v < 0, abs(v)
    out = ""
    while v:
        out = digits[v % base] + out
        v //= base
    return ("-" if neg else "") + out


# ---- JSON bridge -----------------------------------------------------------
def _to_py(v):
    if isinstance(v, JSObject):
        return {k: _to_py(x) for k, x in v.props.items()
                if k != "prototype" and not isinstance(x, JSFunction)}
    if isinstance(v, list):
        return [_to_py(x) for x in v]
    if v is UNDEF:
        return None
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return int(v)
    return v


def _from_py(v):
    if isinstance(v, dict):
        o = JSObject()
        for k, x in v.items():
            o.set(k, _from_py(x))
        return o
    if isinstance(v, list):
        return [_from_py(x) for x in v]
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    return v


def _instanceof(a, b):
    if isinstance(a, TypedArray) and getattr(b, "js_name", None) in (
            "Float32Array", "Uint8Array"):
        return True
    if isinstance(a, JSObject) and isinstance(b, JSFunction):
        proto = b.get("prototype")
        o = a.proto
        while o is not None:
            if o is proto:
                return True
            o = o.proto
    return False


def _binop(self, op, a, b):
    if op == "+":
        if isinstance(a, str) or isinstance(b, str):
            return _to_str(a) + _to_str(b)
        return _to_num(a) + _to_num(b)
    if op in ("-", "*", "/", "%", "**"):
        return _binop_num(op, a, b)
    if op == "===":
        return _strict_eq(a, b)
    if op == "!==":
        return not _strict_eq(a, b)
    if op == "==":
        if (a is None or a is UNDEF) and (b is None or b is UNDEF):
            return True
        return _strict_eq(a, b)
    if op == "!=":
        return not _binop(self, "==", a, b)
    if op in ("<", ">", "<=", ">="):
        if isinstance(a, str) and isinstance(b, str):
            pass
        else:
            a, b = _to_num(a), _to_num(b)
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        return a >= b
    if op == ">>>":
        return float((int(_to_num(a)) & 0xFFFFFFFF) >> int(_to_num(b)))
    if op == ">>":
        return float(int(_to_num(a)) >> int(_to_num(b)))
    if op == "<<":
        return float((int(_to_num(a)) << int(_to_num(b))) & 0xFFFFFFFF)
    if op == "instanceof":
        return _instanceof(a, b)
    if op == "in":
        if isinstance(b, JSObject):
            return _to_str(a) in b.props
        if isinstance(b, list):
            return int(_to_num(a)) < len(b)
        return False
    raise SyntaxError(f"jsmini: unknown binop {op}")


Interp._binop = _binop
