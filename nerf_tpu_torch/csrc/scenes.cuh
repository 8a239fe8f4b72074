// The scene axis of the training kernels' launches (flex_train.cu, #8, and
// paper_train.cu, #9): the multi-scene step evaluates S scenes of one shape
// at once, as the JAX package's vmap of its Pallas training pair gives the
// scene a grid axis of its own.
//
// Each scene's buffers lie end to end in device memory, scene s's at s times
// the buffer's per-scene stride, and each is laid out exactly as a
// single-scene launch's. Every launch takes the scene as its slowest grid
// axis (y of a 1-D grid, z of a 2-D one), so a block keeps its single-scene
// indices on the other axes: it finds its scene's buffers once, on entry,
// and then does what the block of a single-scene launch does, in the same
// order, so each scene's results are bitwise a single-scene launch's. A
// scene's point tiles, chunks and sums never straddle scenes. S = 1 is one
// such launch, but for two passes whose offsets cost time there: the f32
// forward and the bf16 layer-gradient pass launch a *_one_kernel at S = 1,
// the same body on scene 0 with no offsets. The grid's y and z axes hold at
// most 65,535 scenes.
//
// The one exception is the bf16 weight-gradient pass of #9 (wgrad_wg.cuh):
// its persistent blocks walk work items of every scene, with the scene as
// the slowest part of the item's index, and read each scene's residual and
// delta rows through one tensor map over all scenes' rows. Its launcher
// refuses buffers whose scenes do not lie end to end; its partial sums keep
// the per-scene stride, and its chunks never straddle scenes.

#pragma once

namespace scenes {

constexpr int kMaxScenes = 65535;

// Elements from one scene's buffer to the next's (0 where the instance does
// not read the buffer).
struct Strides {
  long long pts, dc, params, wbf, out, res, g, wt, delta, partial, grad, ddc;
};

template <class T>
__device__ __forceinline__ T* at(T* p, long long stride, unsigned int scene) {
  return p + stride * scene;
}

}  // namespace scenes
