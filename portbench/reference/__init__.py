"""The plain reference: float64 brute force in torch, independent of the
program (it imports neither ``repro`` nor ``repro_torch``)."""
