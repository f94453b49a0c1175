"""One runner a kind of cell (``cells/<cell>.json``'s ``kind``): ``serve``
drives the serving engine, ``train`` the train step."""
