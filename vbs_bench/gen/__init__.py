"""The benchmark's frozen input generators: the dome renderer and the seeded
motion (``scene.py``), the gray JPEG encoder and the MJPEG ``.avi`` muxer
(``jpeg.py``). Copies of the port's generators, kept here so that a later
change to the program cannot change the inputs it is measured on."""
