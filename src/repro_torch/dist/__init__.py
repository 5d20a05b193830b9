"""Distribution-side state of the port: the resident-tree codecs
(``dist.quant``, port of ``repro.dist.quant``)."""
