"""The frozen verifier's build of its host C++ engines (``build.py``)."""
