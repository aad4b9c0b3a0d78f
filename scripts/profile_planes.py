"""Attribute the device target-plane build cost (round-4 gradient work).

Measures, on the real chip, per 8-target block:
  - raw-frame upload (cdm+grad+zgap)
  - device plane build dispatch (file mode and otf mode), compile excluded
  - the host oracle build for comparison
Run: python scripts/profile_planes.py [block_size]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from colormipsearch_tpu.imageproc import load_image, label_regions_mask
from colormipsearch_tpu.cds.shape_device import build_target_planes_device
from colormipsearch_tpu.cds.shape_oracle import build_target_shape_planes
from colormipsearch_tpu.imageproc.filters import max_filter_rgb

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "cdsearch")

B = int(sys.argv[1]) if len(sys.argv) > 1 else 8

lms = sorted(n for n in os.listdir(os.path.join(FIX, "lms")))
cdms, grads, zgaps = [], [], []
for i in range(B):
    name = lms[i % len(lms)]
    stem = name.rsplit(".", 1)[0]
    cdm = load_image(os.path.join(FIX, "lms", name))
    gpath = os.path.join(FIX, "grad", stem + ".png")
    if not os.path.exists(gpath):
        continue
    grad = load_image(gpath)
    cdms.append(cdm.pixels)
    grads.append(grad.pixels.astype(np.uint16) if grad.pixels.ndim == 2
                 else grad.pixels)
    zgaps.append(max_filter_rgb(cdm.pixels, 10))
while len(cdms) < B:
    cdms.append(cdms[-1]); grads.append(grads[-1]); zgaps.append(zgaps[-1])

cdm_b = np.stack(cdms)
grad_b = np.stack(grads)
zgap_b = np.stack(zgaps)
h, w = cdm_b.shape[1:3]
excluded = jnp.asarray(label_regions_mask(h, w).astype(bool))
grad_is_rgb = grad_b.ndim == 4

print(f"block {B} x {h}x{w}; grad_is_rgb={grad_is_rgb}; "
      f"upload bytes/target: cdm {cdm_b[0].nbytes/1e6:.1f}MB "
      f"grad {grad_b[0].nbytes/1e6:.1f}MB zgap {zgap_b[0].nbytes/1e6:.1f}MB")

def timeit(label, fn, reps=5):
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best*1e3:.1f} ms/block  ({best/B*1e3:.1f} ms/target)")
    return best

# compile both modes first
t0 = time.perf_counter()
jax.block_until_ready(build_target_planes_device(
    cdm_b, grad_b, zgap_b, excluded, thr=20, zgap_mode="file",
    grad_is_rgb=grad_is_rgb))
print(f"compile file-mode: {time.perf_counter()-t0:.1f}s")
t0 = time.perf_counter()
jax.block_until_ready(build_target_planes_device(
    cdm_b, grad_b, None, excluded, thr=20, zgap_mode="otf",
    grad_is_rgb=grad_is_rgb))
print(f"compile otf-mode: {time.perf_counter()-t0:.1f}s")

timeit("upload only (cdm+grad+zgap)",
       lambda: jax.block_until_ready(
           (jnp.asarray(cdm_b), jnp.asarray(grad_b), jnp.asarray(zgap_b))))
timeit("device build FILE mode (incl. upload)",
       lambda: jax.block_until_ready(build_target_planes_device(
           cdm_b, grad_b, zgap_b, excluded, thr=20, zgap_mode="file",
           grad_is_rgb=grad_is_rgb)))
timeit("device build OTF mode (incl. upload)",
       lambda: jax.block_until_ready(build_target_planes_device(
           cdm_b, grad_b, None, excluded, thr=20, zgap_mode="otf",
           grad_is_rgb=grad_is_rgb)))

# device-resident inputs: isolates the on-device compute from the upload
cdm_d, grad_d, zgap_d = (jnp.asarray(cdm_b), jnp.asarray(grad_b),
                         jnp.asarray(zgap_b))
jax.block_until_ready((cdm_d, grad_d, zgap_d))
timeit("device build FILE mode (device-resident inputs)",
       lambda: jax.block_until_ready(build_target_planes_device(
           cdm_d, grad_d, zgap_d, excluded, thr=20, zgap_mode="file",
           grad_is_rgb=grad_is_rgb)))
timeit("device build OTF mode (device-resident inputs)",
       lambda: jax.block_until_ready(build_target_planes_device(
           cdm_d, grad_d, None, excluded, thr=20, zgap_mode="otf",
           grad_is_rgb=grad_is_rgb)))

t0 = time.perf_counter()
for i in range(B):
    from colormipsearch_tpu.imageproc.io import Image, ImageKind
    build_target_shape_planes(
        Image(ImageKind.RGB, cdm_b[i]),
        Image(ImageKind.RGB, grad_b[i]) if grad_is_rgb
        else Image(ImageKind.GRAY8, grad_b[i].astype(np.uint8)),
        Image(ImageKind.RGB, zgap_b[i]), 20, np.asarray(excluded))
print(f"host oracle build: {(time.perf_counter()-t0)/B*1e3:.1f} ms/target")
