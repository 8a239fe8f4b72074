"""The ``train`` driver: training steps on ray batches drawn from a store.

Set-up renders the store, builds the fields and the optimizer state once
(``engine.train.create_train_state``) with weights from the seed, and the
loop of ``steps_per_call`` steps (``engine.train.make_train_loop``, each
step's rays drawn from the store by the step's generator), as
``train_nerf`` makes it between its prints. Its first call is the warm-up;
the window then calls it on the same state until ``--seconds`` have
passed, and ends in a synchronize.

What is compared, once the window has closed and the state is freed: the
first ``checked_steps`` steps of the warm-up call: each one's loss, the
gradient of step 1 (read back from Adam's first moment: after one step it is
(1 - beta1) times the gradient, beta1 the leaf's parameter group's) and each
leaf's change over those steps,
against the plain reference taking the same steps from the same weights on
the same draws.
"""

from __future__ import annotations

import gc
import os
import resource
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..harness import trace as tr
from ..reference import nerf_plain
from ..traffic.scene import make_store
from .common import (check, launch_checks, named_leaves, norm_gaps, program_config,
                     read_counters, seed_fields, sized, sync, zero_counters)

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by rounding alone: it is left out of the change.
STILL_LEAF = 1e-3


class TrainRun:
    """One run of a training cell on ``device``; ``faults`` plants faults
    under the timed path (for the benchmark's own tests and readings)."""

    def __init__(self, cell, seed: int, device, faults: Sequence[str] = (),
                 sizes: Optional[Dict] = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.faults = set(faults)
        self.model_type = cell.model
        self.config, self.traffic = sized(cell.config, cell.traffic, sizes)
        self.steps_done = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        t0 = time.perf_counter()
        from nerf_tpu_torch.config import (model_from_config, optimizer_from_config,
                                           render_settings_from_config)
        from nerf_tpu_torch.engine import train as engine_train

        t, cfg = self.traffic, program_config(self.config)
        dev = self.device
        t1 = time.perf_counter()
        self.store = make_store(int(t["views"]), int(t["height"]), int(t["width"]),
                                int(t["pose_seed"]), dev)
        sync(dev)
        self.phases = {"import": t1 - t0, "store": time.perf_counter() - t1}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        settings = render_settings_from_config(cfg, "train")
        self.batch = int(cfg.nerf.train.num_random_rays)
        self.k = int(t["steps_per_call"])
        if int(t["checked_steps"]) > self.k:
            raise ValueError("checked_steps must not exceed steps_per_call")
        mc = model_from_config(cfg.models.coarse).to(dev).train()
        mf = model_from_config(cfg.models.fine).to(dev).train()
        seed_fields(self.model_type, [mc, mf], self.seed, dev)
        self.init = {k: p.detach().clone() for k, p in named_leaves(mc, mf).items()}
        self.state = engine_train.create_train_state(mc, mf, optimizer_from_config(cfg))
        self._plant_faults(engine_train)
        self.loop = engine_train.make_train_loop(
            mc, mf, settings, self.batch, self.k, sample_mode=str(cfg.nerf.train.ray_sampling))
        self.counters = self.model_type.plugin.train_counters()
        zero_counters(self.counters)

    def warm_up(self) -> None:
        """The first call of the loop, which the window calls next: its first
        ``checked_steps`` steps are the ones compared. The optimizer's step
        hook keeps step 1's gradient and the leaves after the last of them."""
        checked = int(self.traffic["checked_steps"])
        seen = {}

        def keep(opt, args, kwargs):
            seen["n"] = seen.get("n", 0) + 1
            if seen["n"] == 1:
                self.first_grad = self._adam_gradient()
            if seen["n"] == checked:
                self.after = {k: p.detach().clone() for k, p in self._leaves().items()}

        hook = self.state.optimizer.register_step_post_hook(keep)
        try:
            self.state, m = self.loop(self.state, *self.store, self.seed)
        finally:
            hook.remove()
        if "n" not in seen:          # no update ran: nothing moved
            self.first_grad = {k: torch.zeros_like(p) for k, p in self._leaves().items()}
            self.after = {k: p.detach().clone() for k, p in self._leaves().items()}
        self.first_losses = m.loss[:checked].tolist()
        self.steps_done = self.k
        sync(self.device)

    def _leaves(self) -> Dict[str, torch.Tensor]:
        return named_leaves(self.state.model_coarse, self.state.model_fine)

    def _adam_gradient(self) -> Dict[str, torch.Tensor]:
        opt = self.state.optimizer
        beta1 = {p: group["betas"][0] for group in opt.param_groups for p in group["params"]}
        out = {}
        for name, p in self._leaves().items():
            st = opt.state.get(p, {})
            out[name] = (st["exp_avg"].detach() / (1.0 - beta1[p]) if "exp_avg" in st
                         else torch.zeros_like(p))
        return out

    def _plant_faults(self, engine_train) -> None:
        self._undo = []
        if "unchanged" in self.faults:
            opt = self.state.optimizer
            opt.step = lambda *a, **k: None
        if "half_batch" in self.faults:
            mse = engine_train.img2mse

            def half(a, b):
                return mse(a[: a.shape[0] // 2], b[: b.shape[0] // 2])

            engine_train.img2mse = half
            self._undo.append(lambda: setattr(engine_train, "img2mse", mse))

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Calls of ``steps_per_call`` steps until ``seconds`` have passed,
        from the first call to the synchronize after the last. Each call's
        host clocks are kept beside the rate (``HostClocks``), to tell a
        stall from a slower host."""
        losses = []
        clocks = HostClocks()
        try:
            t0 = time.perf_counter()
            while True:
                clocks.start()
                self.state, m = self.loop(self.state, *self.store, self.seed)
                clocks.stop()
                losses.append(m.loss)
                if time.perf_counter() - t0 >= seconds:
                    break
            calls = len(losses)
            losses = torch.cat(losses).cpu()
            sync(self.device)
            elapsed = time.perf_counter() - t0
        finally:
            clocks.close()
        steps = calls * self.k
        self.steps_done += steps
        return {"seconds": elapsed, "steps": steps,
                "failed": int((~torch.isfinite(losses)).sum()),
                "train_rays_per_s": steps * self.batch / elapsed, **clocks.summary()}

    def traced(self) -> Dict:
        """One more call of ``steps_per_call`` steps, under the profiler."""
        def body():
            self.state, m = self.loop(self.state, *self.store, self.seed)
            m.loss.cpu()
            sync(self.device)

        trace = tr.record(body, self.device.type == "cuda")
        self.steps_done += self.k
        return {"trace": trace, "steps": self.k}

    # -- after the window -----------------------------------------------
    def release(self) -> None:
        """Free the system's state (the reference runs after this)."""
        for undo in self._undo:
            undo()
        self.counts = read_counters(self.counters)
        del self.state, self.loop
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> Dict:
        """The compared numbers of the system's first steps against the
        reference's at the configuration's precision."""
        return compare(self.first_losses, self.first_grad, self.after, self.init,
                       self.reference(self.precision))

    @property
    def precision(self) -> str:
        return str(self.config["nerf"]["train"].get("compute_dtype", "float32"))

    def reference(self, precision: str) -> Dict:
        steps = int(self.traffic["checked_steps"])
        r = nerf_plain.train_steps(self.model_type.field, self.config, self.init, self.store,
                                   self.seed, steps, precision)
        return {"losses": r.losses, "grad": r.first_grad, "after": r.params}

    def checks(self, limits: Dict, readings: Dict) -> List[Dict]:
        steps = self.steps_done
        # A step evaluates the coarse field once and the fine field once.
        return [*(check(k, readings[k], limit) for k, limit in limits.items()),
                *launch_checks(self.counters, self.counts, 2 * steps)]


class HostClocks:
    """The host's clocks around each call of the window: wall time, this
    thread's and the whole process's CPU time (autograd's backward runs on a
    thread of its own), the garbage collector's time, this thread's
    involuntary context switches and minor faults, and the machine's steal
    time (``/proc/stat``, where there is one). A call whose wall time grows
    with its CPU time ran slower on the host; one whose wall time grows
    alone waited (the collector, the device's queue, other processes)."""

    def __init__(self):
        self.wall, self.cpu, self.process, self.switches, self.faults = [], [], [], [], []
        self.gc_s = 0.0
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self.steal0 = steal_s()

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def start(self):
        self._t = (time.perf_counter(), time.thread_time(), time.process_time(),
                   resource.getrusage(resource.RUSAGE_THREAD))

    def stop(self):
        wall, cpu, process, ru = self._t
        now = resource.getrusage(resource.RUSAGE_THREAD)
        self.wall.append(time.perf_counter() - wall)
        self.cpu.append(time.thread_time() - cpu)
        self.process.append(time.process_time() - process)
        self.switches.append(now.ru_nivcsw - ru.ru_nivcsw)
        self.faults.append(now.ru_minflt - ru.ru_minflt)

    def close(self):
        gc.callbacks.remove(self._on_gc)
        self.steal = None if self.steal0 is None else steal_s() - self.steal0

    def summary(self) -> Dict:
        def ms(xs):
            return [round(1e3 * x, 1) for x in xs]

        return {"call_wall_ms": ms(self.wall), "call_cpu_ms": ms(self.cpu),
                "call_process_cpu_ms": ms(self.process),
                "call_involuntary_switches": self.switches, "call_minor_faults": self.faults,
                "gc_s": self.gc_s, "steal_s": self.steal}


def steal_s():
    """Seconds of the machine's CPUs taken by its host, summed over CPUs
    (``/proc/stat``), or None where that is not kept."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / float(os.sysconf("SC_CLK_TCK"))
    except (OSError, IndexError, ValueError):
        return None


def compare(losses: List[float], grad: Dict, after: Dict, init: Dict, ref: Dict) -> Dict:
    """loss_gap: the worst step's loss gap over the reference's loss
    (loss_gap_first: step 1's);
    grad_gap and change_gap: the worst leaf's gap of gradient norms and of
    norms of the change, over the larger of that leaf's reference norm and
    the median leaf's; the change leaves out leaves that the reference
    does not move (gradient under ``STILL_LEAF`` of the median leaf's)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    names = list(init)
    grad_gap = norm_gaps(grad, ref["grad"], names)
    gnorm = {k: float(torch.linalg.vector_norm(ref["grad"][k].double())) for k in names}
    med = statistics.median(gnorm.values())
    moving = [k for k in names if gnorm[k] >= STILL_LEAF * med]
    change = {k: after[k].double() - init[k].double() for k in moving}
    ref_change = {k: ref["after"][k].double() - init[k].double() for k in moving}
    return {"loss_gap": max(gaps), "loss_gap_first": gaps[0], "grad_gap": grad_gap,
            "change_gap": norm_gaps(change, ref_change, moving),
            "still_leaves": len(names) - len(moving)}


def reference_readings(cell, seed: int, device, precision: str, sizes=None) -> Dict:
    """The control's numbers: the reference at ``precision`` in the
    system's place, against the reference at the configuration's precision,
    on the same store and weights. Nothing of the system runs."""
    from nerf_tpu_torch.config import model_from_config

    run = TrainRun(cell, seed, device, sizes=sizes)
    t, cfg, dev = run.traffic, program_config(run.config), run.device
    store = make_store(int(t["views"]), int(t["height"]), int(t["width"]), int(t["pose_seed"]), dev)
    mc = model_from_config(cfg.models.coarse).to(dev)
    mf = model_from_config(cfg.models.fine).to(dev)
    seed_fields(cell.model, [mc, mf], seed, dev)
    init = {k: p.detach().clone() for k, p in named_leaves(mc, mf).items()}
    steps = int(t["checked_steps"])
    field = cell.model.field
    low = nerf_plain.train_steps(field, run.config, init, store, seed, steps, precision)
    ref = nerf_plain.train_steps(field, run.config, init, store, seed, steps, run.precision)
    return compare(low.losses, low.first_grad, low.params, init,
                   {"losses": ref.losses, "grad": ref.first_grad, "after": ref.params})
