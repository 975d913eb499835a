from mcalf_torch.io.spectra import load_spectrum, read_spectrum_table

__all__ = ["load_spectrum", "read_spectrum_table"]
