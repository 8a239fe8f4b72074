"""What both drivers share: the system's configuration built from a
configuration file, weights from the seed and the kernels' launch counters
through the model type's plug-in, and the comparison numbers."""

from __future__ import annotations

import copy
import math
import statistics
from typing import Dict, List, Optional

import torch

PROGRAM_KEYS = ("dataset", "models", "optimizer", "scheduler", "nerf")


def program_config(config: Dict):
    """The system's config tree: its defaults with the file's sections over
    them."""
    from nerf_tpu_torch.config import CfgNode, get_default_config

    cfg = get_default_config()
    cfg.set_new_allowed(True)
    cfg.merge_from_other_cfg(CfgNode({k: config[k] for k in PROGRAM_KEYS}))
    return cfg


def sized(config: Dict, traffic: Dict, sizes: Optional[Dict]):
    """The configuration and traffic of a run, cut down by ``sizes`` for
    the benchmark's own tests on the CPU: ``rays`` a step, ``samples``
    coarse and fine, ``image`` height and width, and any traffic key."""
    sizes = dict(sizes or {})
    config = copy.deepcopy(config)
    if "rays" in sizes:
        config["nerf"]["train"]["num_random_rays"] = sizes.pop("rays")
    if "samples" in sizes:
        n = sizes.pop("samples")
        for mode in ("train", "validation"):
            config["nerf"][mode].update(num_coarse=n, num_fine=n)
    if "image" in sizes:
        config["dataset"].update(height=sizes["image"], width=sizes.pop("image"))
    unknown = set(sizes) - set(traffic)
    if unknown:
        raise KeyError(f"no such traffic keys: {sorted(unknown)}")
    return config, dict(traffic, **sizes)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seed_linears(modules, seed: int, device, opacify: bool, density_bias: str) -> None:
    """Every linear layer of ``modules`` (in order) from one draw of
    uniforms on ``device``: weight and bias ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), the layers' own initialisation. ``opacify`` then scales
    every weight by 3 and adds 2 to the bias of each module's layer
    ``density_bias``, so that a field of random weights renders a scene that
    is mostly opaque, not empty. The seeding of the MLP types' plug-ins."""
    linears = [m for mod in modules for m in mod.modules() if isinstance(m, torch.nn.Linear)]
    total = sum(m.weight.numel() + m.bias.numel() for m in linears)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    off = 0
    with torch.no_grad():
        for m in linears:
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                p.copy_(u[off:off + p.numel()].view_as(p)).mul_(bound)
                off += p.numel()
        if opacify:
            for mod in modules:
                for p in mod.parameters():
                    p.mul_(3.0)
                mod.get_submodule(density_bias).bias.add_(2.0)


def seed_fields(model_type, modules, seed: int, device, opacify: bool = False) -> None:
    """The weights of ``modules`` from ``seed`` by their type's plug-in
    (``model_type``, a ``spec.ModelType``). Every leaf holds NaN until the
    plug-in writes it, so that a leaf it leaves unseeded raises here instead
    of making the comparison with the reference meaningless."""
    with torch.no_grad():
        for mod in modules:
            for p in mod.parameters():
                p.fill_(math.nan)
    model_type.plugin.seed(modules, seed, device, opacify=opacify)
    named = [(f"{i}.{k}", p) for i, mod in enumerate(modules) for k, p in mod.named_parameters()]
    finite = torch.stack([torch.isfinite(p).all() for _, p in named]).tolist()
    unseeded = [k for (k, _), ok in zip(named, finite) if not ok]
    if unseeded:
        raise ValueError(f"{model_type.name}'s plug-in left leaves unseeded: {unseeded}")


def named_leaves(coarse, fine) -> Dict[str, torch.Tensor]:
    """The two fields' parameters as ``coarse.<name>`` / ``fine.<name>``."""
    out = {f"coarse.{k}": p for k, p in coarse.named_parameters()}
    out.update({f"fine.{k}": p for k, p in fine.named_parameters()})
    return out


def zero_counters(counters: Dict) -> None:
    """Counters as a plug-in names them, ``{check: (wrapper, counter,
    launches a field evaluation)}``, set to nought."""
    for holder, attr, _ in counters.values():
        setattr(holder, attr, 0)


def read_counters(counters: Dict) -> Dict[str, int]:
    return {name: getattr(holder, attr) for name, (holder, attr, _) in counters.items()}


def launch_checks(counters: Dict, counts: Dict[str, int], evaluations: int) -> List[Dict]:
    """Each counter's launches against its launches a field evaluation
    times ``evaluations``, exactly."""
    return [check(name, counts[name], per * evaluations, exact=True)
            for name, (_, _, per) in counters.items()]


def check(name: str, value: float, limit: float, exact: bool = False) -> Dict:
    """One compared number: ``value`` at most ``limit``, or equal to it."""
    ok = value == limit if exact else (math.isfinite(value) and value <= limit)
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: List[str]) -> float:
    """The worst leaf of ``keep``: the gap between the norms of ``got`` and
    ``want`` over the larger of that leaf's norm in ``want`` and the median
    leaf's."""
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keep}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    med = statistics.median(w.values())
    worst = 0.0
    for k in keep:
        den = max(w[k], med)
        worst = max(worst, abs(g[k] - w[k]) / den if den > 0 else abs(g[k]))
    return worst
