"""R1CS constraint systems and their batched satisfaction check."""
