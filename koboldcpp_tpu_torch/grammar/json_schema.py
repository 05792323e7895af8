"""JSON-schema -> GBNF grammar converter.

Counterpart of the reference's common/json-schema-to-grammar.cpp (used for
OpenAI tool calling with typed arguments). Supports: type
(object/array/string/number/integer/boolean/null), properties/required,
enum/const, items + minItems/maxItems, anyOf/oneOf, $ref into $defs /
definitions, additionalProperties=false (default for generated objects).
"""
from __future__ import annotations

import json
from typing import Any

_PRIMITIVES = {
    "space": r'( " " | "\n" )?',
    "string": r'"\"" ( [^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}) )* "\"" space',
    "number": r'"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": r'"-"? ([0-9] | [1-9] [0-9]*) space',
    "boolean": r'("true" | "false") space',
    "null": r'"null" space',
    "value": r'object | array | string | number | boolean | null',
    "object": r'"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": r'"[" space ( value ("," space value)* )? "]" space',
}


def _literal(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
    return f'"{out}"'


class _Converter:
    def __init__(self, schema: dict):
        self.root_schema = schema
        self.rules: dict[str, str] = {}
        self.used_prims: set[str] = {"space"}
        self.counter = 0

    def _fresh(self, hint: str) -> str:
        self.counter += 1
        safe = "".join(c if c.isalnum() or c == "-" else "-" for c in hint)
        return f"{safe or 'rule'}-{self.counter}"

    def _prim(self, name: str) -> str:
        self.used_prims.add(name)
        if name in ("value", "object", "array"):
            self.used_prims.update(("value", "object", "array", "string",
                                    "number", "boolean", "null"))
        return name

    def _resolve_ref(self, ref: str) -> dict:
        node: Any = self.root_schema
        for part in ref.lstrip("#/").split("/"):
            node = node[part]
        return node

    def visit(self, schema: Any, hint: str) -> str:
        """Returns a GBNF expression (rule name or inline) for this schema."""
        if schema is True or schema in ({}, None):
            return self._prim("value")
        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]), hint)
        if "const" in schema:
            return _literal(json.dumps(schema["const"]))
        if "enum" in schema:
            alts = " | ".join(_literal(json.dumps(v)) for v in schema["enum"])
            name = self._fresh(hint + "-enum")
            self.rules[name] = f"({alts}) space"
            return name
        for key in ("anyOf", "oneOf"):
            if key in schema:
                alts = " | ".join(self.visit(s, f"{hint}-{i}")
                                  for i, s in enumerate(schema[key]))
                name = self._fresh(hint + "-alt")
                self.rules[name] = alts
                return name

        t = schema.get("type")
        if isinstance(t, list):
            alts = " | ".join(self.visit({**schema, "type": ti}, f"{hint}-{ti}")
                              for ti in t)
            name = self._fresh(hint + "-types")
            self.rules[name] = alts
            return name

        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, hint)
        if t == "array":
            return self._array(schema, hint)
        if t in ("string", "number", "integer", "boolean", "null"):
            return self._prim(t)
        return self._prim("value")

    def _object(self, schema: dict, hint: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", list(props)))
        if not props:
            return self._prim("object")
        name = self._fresh(hint + "-obj")
        parts = []
        first = True
        # fixed property order (like the reference converter): required props
        # in declaration order; optional props become ( "," kv )? groups
        for key, sub in props.items():
            kv = f'{_literal(json.dumps(key))} space ":" space {self.visit(sub, f"{hint}-{key}")}'
            if key in required:
                parts.append(kv if first else f'"," space {kv}')
                first = False
            else:
                parts.append(f'( "," space {kv} )?' if not first
                             else f'( {kv} )?')
        body = " ".join(parts)
        self.rules[name] = f'"{{" space {body} "}}" space'
        return name

    def _array(self, schema: dict, hint: str) -> str:
        items = self.visit(schema.get("items", True), hint + "-item")
        mn = int(schema.get("minItems", 0))
        mx = schema.get("maxItems")
        name = self._fresh(hint + "-arr")
        if mx is not None:
            mx = int(mx)
            if mx == 0:
                self.rules[name] = '"[" space "]" space'
                return name
            extra = mx - max(mn, 1)
            head = " ".join([items] + [f'"," space {items}'] * (max(mn, 1) - 1))
            opt = f'( "," space {items} )' + ("{0,%d}" % extra if extra > 0 else "{0,0}")
            core = f"{head} {opt}" if extra > 0 else head
            body = core if mn > 0 else f"( {core} )?"
        elif mn > 0:
            head = " ".join([items] + [f'"," space {items}'] * (mn - 1))
            body = f'{head} ( "," space {items} )*'
        else:
            body = f'( {items} ( "," space {items} )* )?'
        self.rules[name] = f'"[" space {body} "]" space'
        return name

    def convert(self) -> str:
        root = self.visit(self.root_schema, "root")
        lines = [f"root ::= {root} space" if root in self.rules or root in _PRIMITIVES
                 else f"root ::= {root}"]
        for name, body in self.rules.items():
            lines.append(f"{name} ::= {body}")
        for prim in sorted(self.used_prims):
            lines.append(f"{prim} ::= {_PRIMITIVES[prim]}")
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _Converter(schema).convert()
