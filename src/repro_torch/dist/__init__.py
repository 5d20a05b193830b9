"""Distribution-side code of the port (port of ``repro.dist``): the
resident-tree codecs (``quant``), the int8 error-feedback codec of the
cross-pod reduce (``compress``), the placement rules on a
``torch.distributed`` ``DeviceMesh`` (``shardings``), the ambient
sharding context (``ctx``) and the elastic resize (``elastic``)."""
