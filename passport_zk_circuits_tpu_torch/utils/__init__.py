"""Host-side helpers: the Python-int oracles, RSA key generation, the
Poseidon constants and profiling."""
