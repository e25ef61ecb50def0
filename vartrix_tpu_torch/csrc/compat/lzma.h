// The one liblzma call native/cramio.cpp makes (its lzma block decode),
// declared for machines that ship liblzma's runtime (liblzma.so.5) but not
// its development headers; ops/_build.py puts this directory on the
// include path only where <lzma.h> is missing. The declaration is that of
// liblzma's own <lzma/container.h>, whose ABI is stable under the soname;
// lzma_ret is an enum there, returned as an int.

#ifndef VARTRIX_COMPAT_LZMA_H
#define VARTRIX_COMPAT_LZMA_H

#include <stddef.h>
#include <stdint.h>

extern "C" {

typedef int lzma_ret;
typedef struct lzma_allocator lzma_allocator;

lzma_ret lzma_stream_buffer_decode(uint64_t* memlimit, uint32_t flags,
                                   const lzma_allocator* allocator,
                                   const uint8_t* in, size_t* in_pos,
                                   size_t in_size, uint8_t* out,
                                   size_t* out_pos, size_t out_size);

}  // extern "C"

#endif  // VARTRIX_COMPAT_LZMA_H
