from .ops import Bitflip, Gaussian, Polynomial, bitflip, gaussian, polynomial

__all__ = ["Bitflip", "Gaussian", "Polynomial", "bitflip", "gaussian", "polynomial"]
