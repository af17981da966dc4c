"""Post-training report generation — the port of
``znicz_tpu/utils/publishing.py`` (rebuild of veles/publishing/, SURVEY.md
§3.3 "Publishing": a run report through pluggable backends, Markdown and
self-contained HTML).

``Publisher.publish(workflow)`` collects what a run leaves behind —
config tree, loader split, metric history, best epoch, per-unit timing,
plotter/image-saver artifacts, device and library versions — into one
document.  Backends are registered by name like the loader/normalizer
registries.

The reference's module but for what names the framework: its report
reads ``jax.devices()[0]`` and ``jax.__version__``; the port's
:func:`collect_report` reports the workflow's torch device (a CUDA
device with the card's name) and ``{"torch": ..., "cuda": ...}`` under
the same keys, and the backends render whatever libraries ``versions``
names.
"""

from __future__ import annotations

import html
import os

from znicz_tpu_torch.core.config import Config, root
from znicz_tpu_torch.core.logger import Logger

BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    def deco(cls):
        BACKENDS[name] = cls
        cls.NAME = name
        return cls
    return deco


def device_report(device) -> str:
    """What ran the workflow: a CUDA device as ``cuda:<index> (<card
    name>)``, another torch device by its name, a numpy device (or none)
    by its repr."""
    dev = getattr(device, "torch_device", None)
    if dev is None:
        return repr(device)
    if dev.type != "cuda":
        return str(dev)
    import torch

    index = torch.cuda.current_device() if dev.index is None else dev.index
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"


def collect_report(workflow) -> dict:
    """Gather the report payload (pure data; backends only format)."""
    import torch

    dec = workflow.decision
    loader = workflow.loader
    cfg = {}

    def walk(node, prefix):
        for key, value in sorted(vars(node).items()):
            if isinstance(value, Config):
                walk(value, f"{prefix}{key}.")
            else:
                cfg[f"{prefix}{key}"] = repr(value)

    walk(root, "root.")
    artifacts = []
    for unit in getattr(workflow, "units", []):
        for attr in ("destination", "directory"):
            path = getattr(unit, attr, None)
            if isinstance(path, str) and os.path.exists(path):
                artifacts.append((type(unit).__name__, path))
    return {
        "name": workflow.name,
        "device": device_report(getattr(workflow, "device", None)),
        "versions": {"torch": torch.__version__, "cuda": torch.version.cuda},
        "config": cfg,
        "class_lengths": list(getattr(loader, "class_lengths", [])),
        "history": list(dec.metrics_history),
        "best_metric": dec.best_metric,
        "best_epoch": dec.best_epoch,
        "timing": workflow.timing_table(),
        "artifacts": artifacts,
    }


class BackendBase:
    """Render a collected report to text."""

    EXT = ".txt"

    def render(self, report: dict) -> str:
        raise NotImplementedError


@register_backend("markdown")
class MarkdownBackend(BackendBase):
    EXT = ".md"

    def render(self, report: dict) -> str:
        lines = [f"# {report['name']} — training report", ""]
        lines += [f"- device: `{report['device']}`"]
        lines += [f"- {lib}: {version}"
                  for lib, version in report["versions"].items()]
        lines += [f"- dataset (test/valid/train): "
                  f"{report['class_lengths']}",
                  f"- best metric: **{report['best_metric']}** "
                  f"(epoch {report['best_epoch']})", ""]
        if report["history"]:
            keys = sorted({k for h in report["history"] for k in h})
            lines += ["## Metrics", "",
                      "| " + " | ".join(keys) + " |",
                      "|" + "---|" * len(keys)]
            for h in report["history"]:
                lines.append(
                    "| " + " | ".join(str(h.get(k, "")) for k in keys)
                    + " |")
            lines.append("")
        if report["artifacts"]:
            lines += ["## Artifacts", ""]
            lines += [f"- {kind}: `{path}`"
                      for kind, path in report["artifacts"]]
            lines.append("")
        lines += ["## Timing", "", "```", report["timing"], "```", ""]
        lines += ["## Config", "", "```"]
        lines += [f"{k} = {v}" for k, v in sorted(report["config"].items())]
        lines += ["```", ""]
        return "\n".join(lines)


@register_backend("html")
class HtmlBackend(BackendBase):
    EXT = ".html"

    def render(self, report: dict) -> str:
        h = html.escape
        rows = ""
        keys = sorted({k for hh in report["history"] for k in hh})
        if keys:
            head = "".join(f"<th>{h(k)}</th>" for k in keys)
            body = "".join(
                "<tr>" + "".join(f"<td>{h(str(hh.get(k, '')))}</td>"
                                 for k in keys) + "</tr>"
                for hh in report["history"])
            rows = f"<table><tr>{head}</tr>{body}</table>"
        arts = "".join(f"<li>{h(kind)}: <code>{h(path)}</code></li>"
                       for kind, path in report["artifacts"])
        cfg = "\n".join(f"{h(k)} = {h(v)}"
                        for k, v in sorted(report["config"].items()))
        versions = ", ".join(f"{h(lib)} {h(str(version))}" for lib, version
                             in report["versions"].items())
        return (
            f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{h(report['name'])}</title></head><body>"
            f"<h1>{h(report['name'])} — training report</h1>"
            f"<p>device {h(report['device'])}, "
            f"{versions}, "
            f"best {h(str(report['best_metric']))} "
            f"(epoch {report['best_epoch']})</p>"
            f"{rows}<ul>{arts}</ul>"
            f"<h2>Timing</h2><pre>{h(report['timing'])}</pre>"
            f"<h2>Config</h2><pre>{cfg}</pre>"
            f"</body></html>")


class Publisher(Logger):
    """Render + write a run report (reference: veles/publishing/...
    backends selected by name, ``root.common.publishing.backend``)."""

    def __init__(self, backend: str | None = None,
                 directory: str | None = None) -> None:
        super().__init__()
        name = backend or root.common.get("publishing", Config()).get(
            "backend", "markdown")
        if name not in BACKENDS:
            raise KeyError(f"unknown publishing backend {name!r}; "
                           f"registered: {sorted(BACKENDS)}")
        self.backend = BACKENDS[name]()
        self.directory = directory or os.getcwd()

    def publish(self, workflow) -> str:
        """Write the report; returns the output path."""
        from znicz_tpu_torch.utils.naming import slugify

        report = collect_report(workflow)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory,
            f"{slugify(report['name'])}_report{self.backend.EXT}")
        with open(path, "w") as f:
            f.write(self.backend.render(report))
        self.info(f"report -> {path}")
        return path
