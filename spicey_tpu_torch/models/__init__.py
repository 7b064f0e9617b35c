"""Nonlinear device linearizations (MOSFET level 1, BJT Ebers-Moll, diode
junction charge) on torch tensors."""
