"""The port's host preprocessing library: preprocess.cc, built with g++ at
first use (build.py) and called through ctypes (preprocess.py)."""
