"""The plain reference that decides ``correct``: NumPy only.  It imports
nothing of the program and takes nothing the program made."""
