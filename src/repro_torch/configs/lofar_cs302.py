"""The paper's own problem: LOFAR CS302-like station sky recovery (§4).

Full experiment: 30 LBA antennas (M = 870 cross-correlation baselines),
256×256-pixel sky (N = 65536), 30 strong sources, 0 dB antenna SNR,
b_Φ ∈ {2,4,8,32}, b_y = 8. ``bench`` is the CI-sized version."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CSConfig:
    name: str
    n_antennas: int
    resolution: int
    n_sources: int
    extent: float
    snr_db: float
    bits_phi: int
    bits_y: int
    n_iters: int
    min_sep: int = 4
    seed: int = 302


CONFIG = CSConfig(
    name="lofar-cs302",
    n_antennas=30,
    resolution=256,
    n_sources=30,
    extent=1.5,
    snr_db=0.0,
    bits_phi=2,
    bits_y=8,
    n_iters=60,
)

# CI-sized (same physics, smaller grid)
BENCH = dataclasses.replace(CONFIG, name="lofar-cs302-bench", resolution=64,
                            n_sources=15, n_iters=40)
SMOKE = dataclasses.replace(CONFIG, name="lofar-cs302-smoke", resolution=32,
                            n_sources=8, n_iters=20)
