"""The port's named spans for ``torch.profiler``.

``annotate(name)`` opens a span: under an active profiler a
``torch.profiler.record_function`` range, which the trace holds as a
``user_annotation`` event on the host's clock that the device's events
share; with no profiler active, one shared null context, so a span costs
the port one check of the profiler's state.

The spans sit at the port's layer boundaries, named by the constants below
so that the program and the readers of its traces name them from one place:

- ``train.draw``: a step's generator and ray batch (``engine.train.make_train_loop``);
- ``train.forward``: the render and the two MSEs (``make_train_step``);
- ``train.backward``: ``zero_grad`` and ``loss.backward()``, autograd's
  device thread included;
- ``train.update``: the rest of the step: the all-reduce, the non-finite
  guard, clipping, the optimizer, the schedule, the step's PSNR;
- ``render.field``: one radiance-field evaluation, kernel or plain
  (``engine.renderer``);
- ``field.encode``: a hash-grid field's encoding of its points, kernel or
  plain, inside ``render.field`` (``models.hashgrid``);
- ``render.image``: a pose's pixel rays, chunks, uint8 conversion and
  gather (``make_pose_render_fn``);
- ``serve.request``: one ``RenderService.render_pose`` call, lock wait and
  fetch to the host included.
"""

from __future__ import annotations

import contextlib

import torch

TRAIN_DRAW = "train.draw"
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_UPDATE = "train.update"
RENDER_FIELD = "render.field"
FIELD_ENCODE = "field.encode"
RENDER_IMAGE = "render.image"
SERVE_REQUEST = "serve.request"

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A context manager that records the span ``name`` under an active
    profiler, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
