"""PKI: PEM decoding + DER private-key classification (akka-pki parity,
akka-pki/src/main/scala/akka/pki/pem/).

A copy of `akka_tpu/pki/__init__.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).
"""

from .pem import (DERPrivateKeyLoader, PEMData, PEMLoadingException,
                  PrivateKeyInfo, decode, decode_all, load_certificates,
                  load_private_key)

__all__ = [
    "DERPrivateKeyLoader", "PEMData", "PEMLoadingException",
    "PrivateKeyInfo", "decode", "decode_all", "load_certificates",
    "load_private_key",
]
