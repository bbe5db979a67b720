"""Host-side ingestion: synthetic passports, input tensors, conversion
from the JAX package's numpy inputs."""
