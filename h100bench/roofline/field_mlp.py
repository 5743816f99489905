"""The field MLP that every kernel family runs: five dense layers (fin ->
hid -> hid -> cf + 1 heads, cf -> 3), fin = 2C plane features + posenc."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Mlp:
    C: int            # plane feature channels
    n_pe: int         # posenc width
    hid: int = 128
    cf: int = 64      # radiance feature width

    @property
    def fin(self) -> int:
        return 2 * self.C + self.n_pe

    @property
    def out(self) -> int:
        """rgb ++ features ++ sigma."""
        return 3 + self.cf + 1

    def macs(self) -> int:
        """Multiply-adds a row of the forward."""
        return (self.fin * self.hid + self.hid * self.hid
                + self.hid * (self.cf + 1) + self.cf * 3)

    def params(self) -> int:
        return self.macs() + 2 * self.hid + self.cf + 1 + 3


def from_config(cfg: Dict) -> Mlp:
    """The MLP of a configuration file's dict."""
    c = cfg["config"]["models"]
    n_freq = c["coarse"].get("num_encoding_fn_xyz", 8)
    return Mlp(C=c["coarse"].get("plane_feat_dim", 64), n_pe=6 * n_freq,
               cf=c["StyleUnet"]["inp_ch"])
