"""Operations and bytes of one fused-head launch (encoder, cost head,
z-gradient norm and T MC-dropout passes over N candidates).

Per candidate the algorithm needs these multiply-adds (2 operations each):
the encoder, D*H + (layers - 1)*H*H, and fc_mu, H*L; the head's forward,
L*H0 + H0*H1 + H1; each of the T passes over the kept units of h0, H0*H1
+ H1; and the backward to z, H1*H0 + H0*L. The dropout masks, the ReLUs,
the biases and the variance are not counted. Bytes count each input read
once and each output written once: the rows of X in the compute type,
every weight and bias once, and the four float32 outputs.
"""

from __future__ import annotations


def macs_per_row(D: int, H: int, L: int, H0: int, H1: int, T: int,
                 enc_layers: int = 3) -> int:
    encoder = D * H + (enc_layers - 1) * H * H + H * L
    forward = L * H0 + H0 * H1 + H1
    passes = T * (H0 * H1 + H1)
    backward = H1 * H0 + H0 * L
    return encoder + forward + passes + backward


def ops(N: int, D: int, H: int, L: int, H0: int, H1: int, T: int,
        enc_layers: int = 3) -> int:
    return 2 * N * macs_per_row(D, H, L, H0, H1, T, enc_layers)


def bytes_moved(N: int, D: int, H: int, L: int, H0: int, H1: int,
                itemsize: int, enc_layers: int = 3) -> int:
    weights = (D * H + (enc_layers - 1) * H * H + H * L
               + L * H0 + H0 * H1 + H1)
    biases = enc_layers * H + L + H0 + H1 + 1
    return N * D * itemsize + weights * itemsize + biases * 4 + 4 * N * 4
