"""Regenerate docs/APIREF.md from the live package.

Usage: python docs/_gen_apiref.py
"""

import inspect
import importlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "qinfer_tpu", "qinfer_tpu.abstract_model", "qinfer_tpu.smc",
    "qinfer_tpu.resamplers", "qinfer_tpu.distributions", "qinfer_tpu.domains",
    "qinfer_tpu.derived_models", "qinfer_tpu.test_models", "qinfer_tpu.rb",
    "qinfer_tpu.ale", "qinfer_tpu.heuristics", "qinfer_tpu.expdesign",
    "qinfer_tpu.perf_testing", "qinfer_tpu.simple_est", "qinfer_tpu.clustering",
    "qinfer_tpu.metrics", "qinfer_tpu.utils", "qinfer_tpu.finite_difference",
    "qinfer_tpu.checkpoint", "qinfer_tpu.ipy", "qinfer_tpu.gpu_models",
    "qinfer_tpu.rejuvenation",
    "qinfer_tpu.ops", "qinfer_tpu.ops.accelerated", "qinfer_tpu.ops.resample",
    "qinfer_tpu.parallel", "qinfer_tpu.parallel.mesh",
    "qinfer_tpu.parallel.resample", "qinfer_tpu.parallel.directview",
    "qinfer_tpu.tomography", "qinfer_tpu.tomography.bases",
    "qinfer_tpu.tomography.distributions", "qinfer_tpu.tomography.models",
    "qinfer_tpu.tomography.expdesign", "qinfer_tpu.tomography.plotting_tools",
]


def first_sentence(doc):
    if not doc:
        return ""
    return doc.strip().split("\n")[0].strip()


def main():
    out = ["# API reference — qinfer_tpu", "",
           "Generated from the live package (`python docs/_gen_apiref.py` to",
           "regenerate). One line per public symbol: signature + first "
           "docstring sentence.", ""]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out.append(f"## `{modname}`")
        doc = first_sentence(mod.__doc__)
        if doc:
            out.append(f"\n{doc}\n")
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in dir(mod) if not n.startswith("_")]
        for name in names:
            obj = getattr(mod, name, None)
            if obj is None or inspect.ismodule(obj):
                continue
            if (modname != "qinfer_tpu"
                    and getattr(obj, "__module__", modname) != modname):
                continue
            try:
                if inspect.isclass(obj):
                    sig = str(inspect.signature(obj.__init__)) \
                        .replace("(self, ", "(").replace("(self)", "()")
                    kind = "class"
                elif callable(obj):
                    sig = str(inspect.signature(obj))
                    kind = "def"
                else:
                    out.append(f"- `{name}` — {type(obj).__name__} constant")
                    continue
            except (ValueError, TypeError):
                sig, kind = "(...)", "def"
            if len(sig) > 90:
                sig = sig[:87] + "...)"
            out.append(f"- `{kind} {name}{sig}` — "
                       f"{first_sentence(inspect.getdoc(obj))}")
        out.append("")
    path = os.path.join(os.path.dirname(__file__), "APIREF.md")
    with open(path, "w") as fh:
        fh.write("\n".join(out))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
