"""tkinter launcher GUI.

Port of koboldcpp_tpu/gui.py over the port's parser (cli.build_parser);
counterpart of the reference's show_gui (koboldcpp.py:2202): an
EVERY-FLAG launcher. Instead of hand-maintaining ~1,200 lines of widget
code like the reference, the form is generated by introspecting the argparse
parser (cli.build_parser) — every flag the CLI grows appears here
automatically, grouped into tabs, with checkboxes for store_true flags,
file-browse buttons for model paths, and `.kcpps` save/load that round-trips
with the CLI's config loader.

The schema layer (gui_schema / build_argv) is tkinter-free and unit-tested
headlessly; show_gui is a thin rendering of it.
"""
from __future__ import annotations

import argparse

# flags accepted for compatibility and ignored stay out of the form
_HIDDEN = {
    "usecublas", "usevulkan", "useclblast", "gpulayers", "tensor_split",
    "blasbatchsize", "blasthreads", "threads", "highpriority", "usemmap",
    "usemlock", "noavx2", "failsafe", "nommap", "skiplauncher",
    "model_param", "port_param",
}

# tab assignment by flag name; everything else lands in "Advanced"
_TABS = [
    ("Base", ["model", "port", "host", "contextsize", "multiuser",
              "password", "config", "prompt", "benchmark", "launch"]),
    ("Model", ["lora", "loramult", "mmproj", "quantkv", "ropeconfig",
               "flashattention", "usecpu", "defaultgenamt",
               "maxrequestsize"]),
    ("Context", ["smartcontext", "nocontextshift", "noshift",
                 "nofastforward", "preloadstory", "chatcompletionsadapter"]),
    ("Parallel", ["mesh", "paged", "pagesize", "coordinator",
                  "numprocesses", "processid"]),
    ("Image", ["sdmodel", "sdvaeauto", "sdtaesd", "sdlora", "sdloramult",
               "sdclamped"]),
    ("Audio", ["whispermodel"]),
    ("Horde", ["hordekey", "hordeworkername", "hordemodelname",
               "hordemaxctx", "hordegenlen"]),
    ("Network", ["remotetunnel", "quiet", "debugmode"]),
]

_FILE_FLAGS = {"model", "sdmodel", "whispermodel", "mmproj", "sdtaesd",
               "sdlora", "preloadstory", "config", "lora",
               "chatcompletionsadapter"}


def gui_schema() -> list[tuple[str, list[dict]]]:
    """Introspect the CLI parser into [(tab, [field...])]; field =
    {name, label, kind (bool|int|float|str|file), default, help}."""
    from .cli import build_parser

    parser = build_parser()
    fields: dict[str, dict] = {}
    for a in parser._actions:
        if not a.option_strings or a.dest in _HIDDEN:
            continue
        if isinstance(a, argparse._HelpAction):
            continue
        if a.help == argparse.SUPPRESS:
            continue
        if isinstance(a, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            kind = "bool"
        elif a.dest in _FILE_FLAGS:
            kind = "file"
        elif a.type is int:
            kind = "int"
        elif a.type is float:
            kind = "float"
        else:
            kind = "str"
        default = a.default
        if isinstance(default, list):
            default = " ".join(str(x) for x in default)
        fields[a.dest] = {
            "name": a.dest, "label": a.dest.replace("_", " "),
            "kind": kind, "default": default if default is not None else "",
            "help": a.help or "", "nargs": a.nargs,
        }

    tabs: list[tuple[str, list[dict]]] = []
    used: set[str] = set()
    for tab, names in _TABS:
        fs = [fields[n] for n in names if n in fields]
        used.update(f["name"] for f in fs)
        if fs:
            tabs.append((tab, fs))
    rest = [f for n, f in fields.items() if n not in used]
    if rest:
        tabs.append(("Advanced", rest))
    return tabs


def build_argv(values: dict) -> list[str]:
    """Form values -> argv for cli.main() (pure function; unit-tested)."""
    schema = {f["name"]: f for _, fs in gui_schema() for f in fs}
    argv: list[str] = []
    model = str(values.get("model", "")).strip()
    if model:
        argv.append(model)
    for name, f in schema.items():
        if name == "model":
            continue
        v = values.get(name, f["default"])
        if f["kind"] == "bool":
            if v in (True, "1", "true", "True"):
                argv.append(f"--{name}")
            continue
        if v in ("", None) or str(v) == str(f["default"]):
            continue
        argv.append(f"--{name}")
        # nargs flags (lora, ropeconfig) take space-separated values
        if f.get("nargs") in ("+", "*", 2):
            argv.extend(str(v).split())
        else:
            argv.append(str(v))
    if values.get("benchmark") and "--benchmark" not in argv:
        argv.append("--benchmark")
    return argv


def show_gui():
    import tkinter as tk
    from tkinter import filedialog, ttk

    root = tk.Tk()
    root.title("koboldcpp-tpu-torch launcher")
    nb = ttk.Notebook(root)
    nb.pack(fill="both", expand=True, padx=8, pady=8)
    vars: dict[str, tk.Variable] = {}
    kinds: dict[str, str] = {}

    for tab, fs in gui_schema():
        frm = ttk.Frame(nb, padding=10)
        nb.add(frm, text=tab)
        for row, f in enumerate(fs):
            name, kind = f["name"], f["kind"]
            kinds[name] = kind
            if kind == "bool":
                var = tk.BooleanVar(value=bool(f["default"]))
                vars[name] = var
                cb = ttk.Checkbutton(frm, text=f["label"], variable=var)
                cb.grid(row=row, column=0, columnspan=2, sticky="w", pady=1)
            else:
                ttk.Label(frm, text=f["label"]).grid(
                    row=row, column=0, sticky="w", pady=1)
                var = tk.StringVar(
                    value="" if f["default"] in ("", None)
                    else str(f["default"]))
                vars[name] = var
                ttk.Entry(frm, textvariable=var, width=44).grid(
                    row=row, column=1, sticky="we", pady=1)
                if kind == "file":
                    def browse(v=var):
                        path = filedialog.askopenfilename()
                        if path:
                            v.set(path)
                    ttk.Button(frm, text="...", width=3,
                               command=browse).grid(row=row, column=2)
            if f["help"]:
                ttk.Label(frm, text=f["help"][:70], foreground="#777").grid(
                    row=row, column=3, sticky="w", padx=6)

    result: dict = {}

    def collect() -> dict:
        return {n: (v.get() if kinds[n] == "bool" else v.get())
                for n, v in vars.items()}

    def launch():
        result["argv"] = build_argv(collect())
        root.destroy()

    def save_config():
        import json

        path = filedialog.asksaveasfilename(defaultextension=".kcpps")
        if path:
            with open(path, "w") as f:
                json.dump(collect(), f, indent=1)

    def load_config():
        import json

        path = filedialog.askopenfilename(
            filetypes=[("kcpps config", "*.kcpps *.kcppt *.json")])
        if not path:
            return
        with open(path) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            if k in vars:
                if kinds[k] == "bool":
                    vars[k].set(bool(v))
                else:
                    vars[k].set("" if v in (None, "") else str(v))

    btns = ttk.Frame(root)
    btns.pack(pady=6)
    ttk.Button(btns, text="Launch", command=launch).pack(side="left", padx=4)
    ttk.Button(btns, text="Save .kcpps", command=save_config).pack(side="left", padx=4)
    ttk.Button(btns, text="Load .kcpps", command=load_config).pack(side="left")
    root.mainloop()
    return result.get("argv")


def main():
    argv = show_gui()
    if argv is None:
        return 0
    from .cli import main as cli_main

    return cli_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
