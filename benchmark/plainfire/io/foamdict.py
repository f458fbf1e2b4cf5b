"""OpenFOAM dictionary-format parser.

Parses the case-dictionary format used everywhere in the reference
(controlDict, fvSchemes, fvSolution, constant/*, 0/* field files) into plain
Python structures, so the five bundled reference cases run unmodified.

Behavioural model: OpenFOAM's dictionary / primitiveEntry / ITstream readers
(used by e.g. the reference solver/createFields.H and every case file).
Supported features (all exercised by the reference cases):
  * // and /* */ comments
  * nested sub-dictionaries { }
  * lists ( ... ) including the "N ( ... )" sized form and nested lists/dicts
  * dimension sets [0 1 -1 0 0 0 0] (5 or 7 entries)
  * words with embedded balanced parentheses/angle brackets, e.g.
    div(phi,U), eddyDissipationModel<psiThermoCombustion,gasHThermoPhysics>
  * quoted-string (regex) keywords, e.g. "rho.*" in fvSolution
  * $macro expansion and bare "$other;" dictionary inlining ($U; in fvSolution)
  * #include / #includeIfPresent directives
  * uniform / nonuniform field values (interpreted in io.fields)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

__all__ = [
    "FoamDict",
    "Dimensions",
    "String",
    "parse_string",
    "parse_file",
    "tokenize",
    "expand_env",
    "MISSING",
]


class _Missing:
    def __repr__(self):
        return "<MISSING>"


MISSING = _Missing()


class String(str):
    """A quoted string token (distinct from a bare word)."""

    __slots__ = ()

    def __repr__(self):
        return f'String("{str.__str__(self)}")'


@dataclass(frozen=True)
class Dimensions:
    """A dimension set, e.g. [0 1 -1 0 0 0 0] (mass length time temp mol A cd)."""

    dims: Tuple[float, ...]

    def __iter__(self):
        return iter(self.dims)

    def __repr__(self):
        return "[" + " ".join(str(d) for d in self.dims) + "]"


_PUNCT = "{}()[];"
_WS = " \t\r\n"
_BOOL_WORDS = {
    "yes": True,
    "no": False,
    "on": True,
    "off": False,
    "true": True,
    "false": False,
}


def _as_number(word: str):
    try:
        return int(word)
    except ValueError:
        pass
    try:
        return float(word)
    except ValueError:
        pass
    return None


def tokenize(text: str) -> List[Any]:
    """Tokenize OpenFOAM dictionary text.

    Returns a list of tokens: punctuation chars from ``{}()[];``, ints,
    floats, ``String`` for quoted strings, and ``str`` for bare words.
    """
    toks: List[Any] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in _WS:
            i += 1
            continue
        if c == "/" and i + 1 < n:
            nxt = text[i + 1]
            if nxt == "/":
                j = text.find("\n", i)
                i = n if j < 0 else j + 1
                continue
            if nxt == "*":
                j = text.find("*/", i + 2)
                i = n if j < 0 else j + 2
                continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and text[j] != '"':
                if text[j] == "\\" and j + 1 < n:
                    buf.append(text[j + 1])
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            toks.append(String("".join(buf)))
            i = j + 1
            continue
        if c in _PUNCT:
            toks.append(c)
            i += 1
            continue
        # Bare word or number.  A '(' directly attached to word characters is
        # part of the word (balanced), matching OpenFOAM keyword reading for
        # entries like div(phi,U).
        j = i
        depth = 0
        while j < n:
            ch = text[j]
            if depth > 0:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                j += 1
                continue
            if ch in _WS or ch in '{}[];"':
                break
            if ch == ")":
                break
            if ch == "(":
                if j > i:
                    depth += 1
                    j += 1
                    continue
                break
            if ch == "/" and j + 1 < n and text[j + 1] in "/*":
                break
            j += 1
        word = text[i:j]
        i = j
        num = _as_number(word)
        toks.append(word if num is None else num)
    return toks


class FoamDict(dict):
    """An OpenFOAM dictionary: insertion-ordered with regex-pattern keys.

    Quoted-string keys (e.g. "rho.*" in fvSolution) act as regex patterns on
    lookup, matching OpenFOAM keyType semantics: exact match first, then the
    most recently inserted matching pattern.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.parent: Optional["FoamDict"] = None
        self.name: str = ""

    # -- core lookup ------------------------------------------------------
    def lookup(self, key: str, default=MISSING):
        if key in self:
            return self[key]
        for k in reversed(list(self.keys())):
            if isinstance(k, String):
                try:
                    if re.fullmatch(str(k), key):
                        return self[k]
                except re.error:
                    continue
        if default is MISSING:
            raise KeyError(f"keyword '{key}' not found in dictionary '{self.name}'")
        return default

    def found(self, key: str) -> bool:
        return self.lookup(key, default=None) is not None or key in self

    # -- typed helpers -----------------------------------------------------
    def get_dict(self, key: str, default=MISSING) -> "FoamDict":
        v = self.lookup(key, default)
        if v is default and default is not MISSING:
            return v
        if not isinstance(v, FoamDict):
            raise TypeError(f"entry '{key}' is not a dictionary: {v!r}")
        return v

    def get_scalar(self, key: str, default=MISSING) -> float:
        v = self.lookup(key, default)
        return _coerce_scalar(v, key)

    def get_int(self, key: str, default=MISSING) -> int:
        v = self.lookup(key, default)
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, (int, float)):
            return int(v)
        raise TypeError(f"entry '{key}' is not an int: {v!r}")

    def get_bool(self, key: str, default=MISSING) -> bool:
        v = self.lookup(key, default)
        if isinstance(v, bool):
            return v
        if isinstance(v, str) and v in _BOOL_WORDS:
            return _BOOL_WORDS[v]
        if isinstance(v, (int, float)):
            return bool(v)
        raise TypeError(f"entry '{key}' is not a switch: {v!r}")

    def get_word(self, key: str, default=MISSING) -> str:
        v = self.lookup(key, default)
        if isinstance(v, list) and v:
            v = v[0]
        if not isinstance(v, str):
            raise TypeError(f"entry '{key}' is not a word: {v!r}")
        return str(v)

    def get_vector(self, key: str, default=MISSING):
        v = self.lookup(key, default)
        if v is default and not isinstance(v, (list, tuple)):
            return v
        if isinstance(v, list) and len(v) == 3 and all(
            isinstance(x, (int, float)) for x in v
        ):
            return tuple(float(x) for x in v)
        # dimensioned vector: [name] [dims] (x y z)
        if isinstance(v, list):
            for item in reversed(v):
                if isinstance(item, list) and len(item) == 3:
                    return tuple(float(x) for x in item)
        raise TypeError(f"entry '{key}' is not a vector: {v!r}")

    def get_list(self, key: str, default=MISSING) -> list:
        v = self.lookup(key, default)
        if isinstance(v, list):
            return v
        return [v]

    def subdicts(self):
        for k, v in self.items():
            if isinstance(v, FoamDict):
                yield k, v

    def merge(self, other: "FoamDict"):
        for k, v in other.items():
            self[k] = v


def _coerce_scalar(v, key="") -> float:
    """Extract a scalar from a primitive entry, tolerating the dimensioned
    forms ``name [dims] val``, ``[dims] val`` and bare ``val``."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, list):
        nums = [x for x in v if isinstance(x, (int, float)) and not isinstance(x, bool)]
        if nums:
            return float(nums[-1])
    raise TypeError(f"entry '{key}' is not a scalar: {v!r}")


def expand_env(s: str, case_dir: Optional[str] = None) -> str:
    """Expand $FOAM_CASE and environment variables in a path string."""
    if case_dir is not None:
        s = s.replace("$FOAM_CASE", str(case_dir))
    return os.path.expandvars(s)


class _Parser:
    def __init__(self, tokens: List[Any], file_dir: Optional[str], case_dir: Optional[str]):
        self.toks = tokens
        self.i = 0
        self.file_dir = file_dir
        self.case_dir = case_dir

    def eof(self) -> bool:
        return self.i >= len(self.toks)

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    # -- directives --------------------------------------------------------
    def _handle_directive(self, word: str, d: FoamDict):
        if word in ("#include", "#includeIfPresent", "#sinclude", "#includeFunc"):
            fname = self.next()
            path = expand_env(str(fname), self.case_dir)
            cands = []
            if os.path.isabs(path):
                cands = [path]
            else:
                if self.file_dir:
                    cands.append(os.path.join(self.file_dir, path))
                if self.case_dir:
                    cands.append(os.path.join(self.case_dir, path))
                cands.append(path)
            found = next((c for c in cands if os.path.isfile(c)), None)
            if found is None:
                if word == "#include":
                    raise FileNotFoundError(
                        f"#include file not found: {fname} (tried {cands})"
                    )
                return
            with open(found) as f:
                sub = tokenize(f.read())
            self.toks[self.i : self.i] = sub
        elif word == "#inputMode":
            self.next()  # merge/overwrite/...
        elif word == "#remove":
            target = self.next()
            names = target if isinstance(target, list) else [target]
            for nm in names:
                d.pop(nm, None)
        elif word == "#neg":
            # #neg value -> negate the next numeric token in place
            val = self.next()
            self.toks.insert(self.i, -val)
        else:
            # Unknown directive: skip it and its argument if it looks attached.
            pass

    # -- macro resolution ---------------------------------------------------
    def _resolve_macro(self, name: str, scope: FoamDict):
        key = name[1:]
        if key.startswith("{") and key.endswith("}"):
            key = key[1:-1]
        d: Optional[FoamDict] = scope
        while d is not None:
            v = d.lookup(key, default=None)
            if v is not None:
                return v
            d = d.parent
        return None

    # -- structure parsing ---------------------------------------------------
    def parse_dict(self, d: FoamDict, end: Optional[str]) -> FoamDict:
        while not self.eof():
            t = self.peek()
            if end is not None and t == end:
                self.next()
                return d
            t = self.next()
            if isinstance(t, str) and not isinstance(t, String) and t.startswith("#"):
                self._handle_directive(t, d)
                continue
            if t == ";":
                continue
            keyword = t
            # $other;  -> inline the referenced entry (dict merge)
            if (
                isinstance(keyword, str)
                and keyword.startswith("$")
                and self.peek() == ";"
            ):
                self.next()
                ref = self._resolve_macro(keyword, d)
                if isinstance(ref, FoamDict):
                    d.merge(ref)
                elif ref is not None:
                    d[keyword[1:]] = ref
                continue
            nxt = self.peek()
            if nxt == "{":
                self.next()
                sub = FoamDict()
                sub.parent = d
                sub.name = str(keyword)
                self.parse_dict(sub, "}")
                key = self._mkkey(keyword)
                if key in d and isinstance(d[key], FoamDict):
                    d[key].merge(sub)
                else:
                    d[key] = sub
            else:
                value = self._parse_primitive(d)
                d[self._mkkey(keyword)] = value
        # Lenient EOF: reference case files exist with a missing closing brace
        # (e.g. steckler constant/combustionProperties) and OpenFOAM accepts
        # them, so unterminated dictionaries close at EOF.
        return d

    @staticmethod
    def _mkkey(keyword):
        return keyword if isinstance(keyword, String) else str(keyword)

    def _parse_primitive(self, scope: FoamDict):
        items: List[Any] = []
        while not self.eof():
            t = self.peek()
            if t == ";":
                self.next()
                break
            if t == "}":
                break  # tolerate missing ';' before closing brace
            t = self.next()
            if t == "(":
                items.append(self._parse_list(scope))
            elif t == "[":
                items.append(self._parse_dimensions())
            elif t == "{":
                sub = FoamDict()
                sub.parent = scope
                self.parse_dict(sub, "}")
                items.append(sub)
            elif isinstance(t, str) and not isinstance(t, String) and t.startswith("$"):
                v = self._resolve_macro(t, scope)
                items.append(v if v is not None else t)
            else:
                items.append(t)
        if len(items) == 1:
            return items[0]
        return items

    def _parse_list(self, scope: FoamDict) -> list:
        out: List[Any] = []
        while not self.eof():
            t = self.next()
            if t == ")":
                return out
            if t == "(":
                out.append(self._parse_list(scope))
            elif t == "{":
                sub = FoamDict()
                sub.parent = scope
                self.parse_dict(sub, "}")
                out.append(sub)
            elif t == "[":
                out.append(self._parse_dimensions())
            elif isinstance(t, str) and not isinstance(t, String) and t.startswith("$"):
                v = self._resolve_macro(t, scope)
                out.append(v if v is not None else t)
            else:
                out.append(t)
        raise ValueError("unexpected EOF while parsing list")

    def _parse_dimensions(self) -> Dimensions:
        nums: List[float] = []
        while not self.eof():
            t = self.next()
            if t == "]":
                break
            if isinstance(t, (int, float)):
                nums.append(float(t))
            # ignore words inside dimension brackets (units like [m] unused)
        return Dimensions(tuple(nums))


def parse_string(
    text: str, file_dir: Optional[str] = None, case_dir: Optional[str] = None
) -> FoamDict:
    p = _Parser(tokenize(text), file_dir, case_dir)
    root = FoamDict()
    root.name = "<root>"
    return p.parse_dict(root, None)


def parse_file(path: Union[str, os.PathLike], case_dir: Optional[str] = None) -> FoamDict:
    path = os.fspath(path)
    with open(path) as f:
        text = f.read()
    d = parse_string(text, file_dir=os.path.dirname(path), case_dir=case_dir)
    d.name = path
    return d
