"""KPM density of states (paper Figs. 7/8, reduced scale) on the PyTorch
port.

    PYTHONPATH=src python examples/torch_dos_kpm.py [--device cpu]

Computes the kernel-polynomial-method DOS of a Hubbard matrix with the
same Chebyshev machinery as the FD filter (stochastic trace over random
vectors), and validates the histogram against dense eigh. Runs on the
card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import build_dist_ell, make_spmv
from repro_torch.core.chebyshev import kpm_dos, kpm_moments, scale_params
from repro_torch.core.lanczos import lanczos_interval
from repro_torch.device import resolve_device
from repro_torch.matrices import Hubbard


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mat = Hubbard(8, 4, U=6.0, ranpot=1.0)
    csr = mat.build_csr()
    D = csr.shape[0]
    print(f"matrix: {mat.describe()} on {dev}")
    ell = build_dist_ell(csr, 1, device=dev)
    spmv = make_spmv(ell, use_kernel=True)
    D_pad = ell.R * ell.P
    lam = lanczos_interval(spmv, D, torch.float64, dev, D_pad=D_pad,
                           generator=torch.Generator(dev).manual_seed(0))
    alpha, beta = scale_params(*lam)
    gen = torch.Generator(dev).manual_seed(1)
    R = torch.randint(0, 2, (D_pad, 16), generator=gen, device=dev,
                      dtype=torch.float64) * 2 - 1  # Rademacher
    R[D:] = 0
    mu = kpm_moments(spmv, alpha, beta, R, n_moments=256).cpu().numpy() / 16
    x, rho = kpm_dos(mu, n_bins=256)
    lam_axis = (x - beta) / alpha

    # validate against the exact spectrum histogram
    w = np.linalg.eigvalsh(csr.to_dense())
    # fraction of eigenvalues below the U-gap, KPM vs exact
    split = float(np.median(w))
    kpm_frac = float(np.trapezoid(rho * (lam_axis < split), lam_axis)
                     / np.trapezoid(rho, lam_axis))
    true_frac = float((w < split).mean())
    print(f"spectral weight below lambda={split:.2f}: KPM {kpm_frac:.3f} "
          f"vs exact {true_frac:.3f}")
    assert abs(kpm_frac - true_frac) < 0.05
    # coarse DOS shape: correlation between KPM and exact histograms
    hist, edges = np.histogram(w, bins=48, range=(lam_axis[0], lam_axis[-1]),
                               density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    kpm_on_centers = np.interp(centers, lam_axis, rho * alpha)
    corr = np.corrcoef(hist, kpm_on_centers)[0, 1]
    print(f"DOS shape correlation (48 bins): {corr:.3f}")
    assert corr > 0.9
    print("OK — KPM DOS matches the exact spectrum (Figs. 7/8 machinery)")


if __name__ == "__main__":
    main()
