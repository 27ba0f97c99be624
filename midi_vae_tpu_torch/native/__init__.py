"""Host C++ runtime of the port: the threaded RRD loader and the SMF parser,
built with g++ at first use (``_build.py``)."""
