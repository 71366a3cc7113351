"""Model families of the LM zoo: the dense decoder-only transformer
(``decoder``) and the family dispatch (``registry``)."""
