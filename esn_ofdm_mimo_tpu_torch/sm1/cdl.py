"""TR 38.901 CDL-B *spatial* clustered-ray channel for system model 1
(port of esn_ofdm_mimo_tpu/sm1/cdl.py).

The reference's `sionna.channel.tr38901.CDL("B", 300e-9, 2.6e9, ut_array,
bs_array, "uplink", min_speed=10)` + `cir_to_ofdm_channel(frequencies,
*cir, normalize=True)` (esn_ofdm_mimo_via_cdl.py:48-60, 244-246): 23
clusters x 20 rays with per-cluster angle spreads, dual-polarized cross
arrays with the 38.901 element pattern, fixed XPR, random ray coupling,
per-ray random phases and Doppler from UT motion.

The tables are the JAX package's (TR 38.901 Tables 7.7.1-2 and 7.5-3).
The random draws keep its key order, split(key, 3) into coupling, phase
and velocity, through the port's bit-exact RNG, so both packages draw the
same rays; angles are float32 as there. The JAX package ran its complex
contractions as four real einsums because its TPU backend lacked complex
matmuls; here they are complex64 einsums.

Simplifications (as in the JAX package): no intra-cluster delay splitting
of the two strongest clusters; array orientations are identity.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils import rng

# --- Table 7.7.1-2: CDL-B (23 clusters) -------------------------------------
CDLB_DELAYS = np.array([
    0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752, 0.5055, 0.3681,
    0.3697, 0.5700, 0.5283, 1.1021, 1.2756, 1.5474, 1.7842, 2.0169, 2.8294,
    3.0219, 3.6187, 4.1067, 4.2790, 4.7834])
CDLB_POWERS_DB = np.array([
    0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6, -3.0, -8.9, -9.0,
    -4.8, -5.7, -7.5, -1.9, -7.6, -12.2, -9.8, -11.4, -14.9, -9.2, -11.3])
CDLB_AOD = np.array([
    9.3, 9.3, 9.3, -34.1, -65.4, -11.4, -11.4, -11.4, -67.2, 52.5, -72.0,
    74.3, -52.2, -50.5, 61.4, 30.6, -72.5, -90.6, -77.6, -82.6, -103.6,
    75.6, -77.6])
CDLB_AOA = np.array([
    -173.3, -173.3, -173.3, 125.5, -88.0, 155.1, 155.1, 155.1, -89.8, 132.1,
    -83.6, 95.3, 103.7, -87.8, -92.5, -139.1, -90.6, 58.6, -79.0, 65.8,
    52.7, 88.7, -60.3])
CDLB_ZOD = np.array([
    105.8, 105.8, 105.8, 115.3, 119.3, 103.2, 103.2, 103.2, 118.2, 102.0,
    100.4, 98.3, 103.4, 102.5, 101.4, 103.0, 100.0, 115.2, 100.5, 119.6,
    118.7, 117.8, 115.7])
CDLB_ZOA = np.array([
    78.9, 78.9, 78.9, 63.3, 59.9, 67.5, 67.5, 67.5, 82.6, 66.3, 61.6, 58.0,
    78.2, 82.0, 62.4, 78.0, 60.9, 82.9, 60.8, 57.3, 59.9, 60.1, 62.3])
CDLB_C_ASD, CDLB_C_ASA = 10.2, 22.0
CDLB_C_ZSD, CDLB_C_ZSA = 1.5, 7.0
CDLB_XPR_DB = 8.0

# --- Table 7.5-3: ray offset angles ------------------------------------------
RAY_OFFSETS = np.array([
    0.0447, -0.0447, 0.1413, -0.1413, 0.2492, -0.2492, 0.3715, -0.3715,
    0.5129, -0.5129, 0.6797, -0.6797, 0.8844, -0.8844, 1.1481, -1.1481,
    1.5195, -1.5195, 2.1551, -2.1551])

_DEG = np.pi / 180.0


@dataclasses.dataclass(frozen=True)
class CdlConfig:
    """CDL link parameters (reference esn_ofdm_mimo_via_cdl.py:48-60)."""
    delay_spread: float = 300e-9
    carrier_frequency: float = 2.6e9
    speed: float = 10.0              # m/s (min_speed == max_speed == 10)
    num_ut_ports: int = 4            # 1 x (ports/2) dual-pol cross ULA
    num_bs_ports: int = 8
    direction: str = "uplink"        # UT transmits; BS receives


def _cross_pol_ula(num_ports: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dual-polarized cross ULA: (ports, 3) positions in wavelengths along
    y with 0.5-wl spacing, and (ports,) slant angles (+45/-45 deg).

    Port order: all +45-slant elements, then all -45 (Sionna AntennaArray
    with polarization='dual', polarization_type='cross')."""
    cols = num_ports // 2
    pos1 = np.stack([np.zeros(cols), 0.5 * np.arange(cols),
                     np.zeros(cols)], -1)
    pos = np.concatenate([pos1, pos1], axis=0)
    slant = np.concatenate([np.full(cols, 45.0), np.full(cols, -45.0)]) * _DEG
    return pos, slant


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _pattern_amp(zen_deg: torch.Tensor, az_deg: torch.Tensor
                 ) -> torch.Tensor:
    """38.901 element amplitude gain sqrt(10^(A/10)) (Table 7.3-1)."""
    az = torch.remainder(az_deg + 180.0, 360.0) - 180.0
    a_v = -torch.clamp_max(12.0 * ((zen_deg - 90.0) / 65.0) ** 2, 30.0)
    a_h = -torch.clamp_max(12.0 * (az / 65.0) ** 2, 30.0)
    a_db = 8.0 - torch.clamp_max(-(a_v + a_h), 30.0)
    return 10.0 ** (a_db / 20.0)


def _unit_vec(zen_deg: torch.Tensor, az_deg: torch.Tensor) -> torch.Tensor:
    """Spherical unit vector r_hat (..., 3)."""
    th, ph = zen_deg * _DEG, az_deg * _DEG
    st = torch.sin(th)
    return torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                        torch.cos(th)], -1)


def _permuted_offsets(key: torch.Tensor, batch: int, n_clusters: int,
                      n_sets: int) -> torch.Tensor:
    """(n_sets, B, N, M) independently permuted ray offsets (random
    coupling of ray angles, 38.901 §7.7.1 step 2 / §7.5 step 8): a stable
    argsort of uniforms, as jnp.argsort."""
    M = len(RAY_OFFSETS)
    u = rng.uniform(key, (n_sets, batch, n_clusters, M))
    idx = torch.argsort(u, dim=-1, stable=True)
    return _f32(RAY_OFFSETS, key.device)[idx]


def cdl_cir(cfg: CdlConfig, key: torch.Tensor, batch: int, num_times: int,
            sampling_frequency: float):
    """Draw the clustered-ray CIR on the key's device.

    Returns (a, tau): a (B, U_rx, S_tx, N_clusters, T) complex64 per-cluster
    gains over time, tau (N_clusters,) float32 delays in seconds.
    """
    dev = key.device
    N, M = len(CDLB_DELAYS), len(RAY_OFFSETS)
    k_coup, k_phase, k_vel = rng.split(key, 3)

    p_lin = 10.0 ** (CDLB_POWERS_DB / 10.0)
    p_lin = p_lin / p_lin.sum()
    tau = _f32(CDLB_DELAYS * cfg.delay_spread, dev)

    # Uplink: departure side is the UT -> table A{o,z}A spreads apply at the
    # transmitter, A{o,z}D at the receiving BS (link reversal).
    if cfg.direction != "uplink":
        raise NotImplementedError("only the reference's uplink is modelled")
    dep_az_c, dep_zen_c = CDLB_AOA, CDLB_ZOA          # UT side
    arr_az_c, arr_zen_c = CDLB_AOD, CDLB_ZOD          # BS side
    dep_az_s, dep_zen_s = CDLB_C_ASA, CDLB_C_ZSA
    arr_az_s, arr_zen_s = CDLB_C_ASD, CDLB_C_ZSD

    # Ray angles with random coupling: departure-azimuth offsets in table
    # order; the other three sets independently permuted per (batch,cluster).
    off = _permuted_offsets(k_coup, batch, N, 3)
    base = _f32(RAY_OFFSETS, dev).expand(batch, N, M)
    dep_az = _f32(dep_az_c, dev)[None, :, None] + dep_az_s * base
    arr_az = _f32(arr_az_c, dev)[None, :, None] + arr_az_s * off[0]
    dep_zen = _f32(dep_zen_c, dev)[None, :, None] + dep_zen_s * off[1]
    arr_zen = _f32(arr_zen_c, dev)[None, :, None] + arr_zen_s * off[2]

    # Field patterns (+/-45 deg slants, polarization model 2): the pattern
    # amplitude is port-independent; the slant splits it into (F_th, F_ph).
    tx_pos, tx_slant = _cross_pol_ula(cfg.num_ut_ports)
    rx_pos, rx_slant = _cross_pol_ula(cfg.num_bs_ports)
    amp_tx = _pattern_amp(dep_zen, dep_az)            # (B,N,M)
    amp_rx = _pattern_amp(arr_zen, arr_az)

    # Random per-ray initial phases and the fixed-XPR polarization matrix.
    phases = rng.uniform(k_phase, (4, batch, N, M), -np.pi, np.pi)
    inv_sqrt_kappa = 10.0 ** (-CDLB_XPR_DB / 20.0)
    x_tt = torch.polar(torch.ones_like(phases[0]), phases[0])
    x_tp = inv_sqrt_kappa * torch.polar(torch.ones_like(phases[1]), phases[1])
    x_pt = inv_sqrt_kappa * torch.polar(torch.ones_like(phases[2]), phases[2])
    x_pp = torch.polar(torch.ones_like(phases[3]), phases[3])

    # coef[b,n,m,u,s] = amp_rx amp_tx (rc tc x_tt + rc ts x_tp + rs tc x_pt
    # + rs ts x_pp), the port slants (rc, rs) / (tc, ts) factored out
    rc = _f32(np.cos(rx_slant), dev)[:, None]         # (U,1)
    rs = _f32(np.sin(rx_slant), dev)[:, None]
    tc = _f32(np.cos(tx_slant), dev)[None, :]         # (1,S)
    ts = _f32(np.sin(tx_slant), dev)[None, :]
    pol = ((rc * tc) * x_tt[..., None, None]
           + (rc * ts) * x_tp[..., None, None]
           + (rs * tc) * x_pt[..., None, None]
           + (rs * ts) * x_pp[..., None, None])
    coef = (amp_rx * amp_tx).to(torch.complex64)[..., None, None] * pol

    # Array response phases (positions in wavelengths -> 2*pi*(r_hat . pos)).
    r_dep = _unit_vec(dep_zen, dep_az)                # (B,N,M,3)
    r_arr = _unit_vec(arr_zen, arr_az)
    ph_tx = 2 * np.pi * torch.einsum("bnmk,sk->bnms", r_dep,
                                     _f32(tx_pos, dev))
    ph_rx = 2 * np.pi * torch.einsum("bnmk,uk->bnmu", r_arr,
                                     _f32(rx_pos, dev))
    ph = ph_rx[..., :, None] + ph_tx[..., None, :]
    g = coef * torch.polar(torch.ones_like(ph), ph)   # (B,N,M,U,S)

    # Doppler: the UT moves at `speed` in a random horizontal direction;
    # phase rate from the UT-side (departure) ray directions.
    lam = 299792458.0 / cfg.carrier_frequency
    phi_v = rng.uniform(k_vel, (batch,), 0.0, 2 * np.pi)
    v = (cfg.speed / lam) * torch.stack(
        [torch.cos(phi_v), torch.sin(phi_v), torch.zeros_like(phi_v)], -1)
    t = torch.arange(num_times, dtype=torch.float32,
                     device=dev) / sampling_frequency
    dop_rate = 2 * np.pi * torch.einsum("bnmk,bk->bnm", r_dep, v)
    arg = dop_rate[..., None] * t
    dop = torch.polar(torch.ones_like(arg), arg)      # (B,N,M,T)

    # Sum rays: a[b,n,u,s,t] = sqrt(P_n/M) sum_m g[b,n,m,u,s] dop[b,n,m,t]
    a = torch.einsum("bnmus,bnmt->bnust", g, dop)
    scale = torch.as_tensor(np.sqrt(p_lin / M), dtype=torch.complex64,
                            device=dev)
    a = a * scale[None, :, None, None, None]
    return a.permute(0, 2, 3, 1, 4).contiguous(), tau


def cir_to_ofdm_channel(frequencies: np.ndarray, a: torch.Tensor,
                        tau: torch.Tensor, normalize: bool = True
                        ) -> torch.Tensor:
    """Per-subcarrier frequency response from the clustered CIR.

    frequencies: (F,) baseband Hz; a: (B,U,S,N,T); tau: (N,).
    Returns h_f (B,T,F,U,S) complex64 — sionna.channel.cir_to_ofdm_channel
    semantics (reference :245); normalize=True gives unit mean RE energy
    per batch example across (T,F,U,S).
    """
    f = _f32(frequencies, a.device)
    phase = -2 * np.pi * f[None, :] * tau[:, None]    # (N,F)
    e = torch.polar(torch.ones_like(phase), phase)
    h = torch.einsum("busnt,nf->btfus", a, e)
    if normalize:
        c = (h.abs() ** 2).mean(dim=(1, 2, 3, 4), keepdim=True)
        h = h / torch.sqrt(c)
    return h.to(torch.complex64)
