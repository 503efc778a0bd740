"""Host-side native components of the port: the C++ data loader
(``loader.cc``, built with g++ at first use into ``_build/``)."""
