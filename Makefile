# Top-level build: native decoder library, C tools, sanitizer build.
# The Python package builds the library automatically on first import;
# this Makefile exists for explicit/offline builds (SURVEY 2f parity).

NATIVE_DIR := easyav1/native
SO := $(NATIVE_DIR)/libeasyav1.so
SRCS := $(NATIVE_DIR)/av1_tile.c $(NATIVE_DIR)/av1_recon.c \
        $(NATIVE_DIR)/av1_recon8.c $(NATIVE_DIR)/vorbis_dec.c
HDRS := $(wildcard $(NATIVE_DIR)/*.h)

all: $(SO) tools

$(SO): $(SRCS) $(HDRS)
	gcc -O3 -funroll-loops -march=native -shared -fPIC -pthread -o $@ $(SRCS) -lm

tools:
	$(MAKE) -C tools

sanitize:
	$(MAKE) -C tools sanitize

test: $(SO)
	python -m pytest tests/ -q

clean:
	rm -f $(SO)
	rm -rf tools/build

.PHONY: all tools sanitize test clean
