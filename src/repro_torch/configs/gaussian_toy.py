"""The paper's Gaussian toy (supplementary §10 / Fig. 11):
Φ ∈ R^{256×512}, s-sparse x, SNR sweep, 100 realizations."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    name: str
    m: int = 256
    n: int = 512
    s: int = 16
    n_iters: int = 50
    n_realizations: int = 100
    snr_grid: tuple = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
    bits_phi: int = 2
    bits_y: int = 8


CONFIG = GaussianConfig(name="gaussian-toy")
SMOKE = GaussianConfig(name="gaussian-toy-smoke", m=64, n=128, s=6, n_iters=25,
                       n_realizations=5, snr_grid=(0.0, 20.0))
